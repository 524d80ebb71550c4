"""DitheringApp: the interactive GUI (tkinter/ttk), on the port's ditherer.

The JAX package's app (``dither_pie_tpu/gui/app.py``), feature for feature:
sidebar (open image/video, random frame, pixelize regular/neural/editor,
final-resize multiplier with live size preview, dither mode dropdown + gear
settings, colour count, apply/save/fit/toggle), zoomable main viewer with a
current/pixelized/dithered display state machine that preserves zoom/pan,
palette selection dialog with generated + palette.json entries, colour-bar
previews, background-thread live preview with a 30-entry LRU cache keyed on
(palette, gamma, mode, params), lospec import, palette-from-image, video
apply on a worker thread, and config persistence on close.

Every state transition and processing decision lives in the headless
AppViewModel (``gui/viewmodel.py``, driven end to end without a display);
this module is widget glue: dialogs, the viewer, threads, and the status
bar. The device is resolved once, before any window opens (``"cuda"`` by
default; CUDA on a machine without a card raises), and every preview,
palette and pixelization runs on it through the same ImageDitherer and
pipeline code as the command line.
"""

from __future__ import annotations

import threading
import tkinter as tk
from pathlib import Path
from tkinter import filedialog, messagebox, simpledialog, ttk
from typing import Any, Dict, Optional

from PIL import Image

from dither_pie_tpu_torch.api.config_manager import ConfigManager
from dither_pie_tpu_torch.api.ditherer import DitherMode, ImageDitherer
from dither_pie_tpu_torch.api.runtime import DeviceLike, resolve_device
from dither_pie_tpu_torch.gui.viewmodel import AppViewModel, theme_palette
from dither_pie_tpu_torch.gui.widgets import (CustomPaletteCreator,
                                              DitherSettingsDialog,
                                              ImageComparisonView,
                                              PaletteImagePreviewDialog,
                                              PalettePreview,
                                              PixelizationEditorDialog,
                                              ProgressDialog, StatusBar,
                                              ZoomableImage)
from dither_pie_tpu_torch.utils import IMAGE_EXTENSIONS, VIDEO_EXTENSIONS

CLI_HINT = "python -m dither_pie_tpu_torch <config.json> [input] [--device cpu]"


class DitheringApp:
    def __init__(self, root: Optional[tk.Tk] = None, device: DeviceLike = "cuda"):
        device = resolve_device(device)  # before any window opens
        self.root = root or tk.Tk()
        self.root.title(f"Dither Pie ({device.type})")
        self.config = ConfigManager()
        self.vm = AppViewModel(self.config, device)
        try:
            self.root.geometry(self.config.get_window_geometry())
        except Exception:
            pass

        self._apply_theme()
        self._build_ui()

        self.root.protocol("WM_DELETE_WINDOW", self._on_close)

    # State proxies: the view-model owns the state machine; widget code and
    # the smoke tests read/write it through the app object.

    @property
    def current_image(self):
        return self.vm.current_image

    @current_image.setter
    def current_image(self, v):
        self.vm.current_image = v

    @property
    def pixelized_image(self):
        return self.vm.pixelized_image

    @pixelized_image.setter
    def pixelized_image(self, v):
        self.vm.pixelized_image = v

    @property
    def dithered_image(self):
        return self.vm.dithered_image

    @dithered_image.setter
    def dithered_image(self, v):
        self.vm.dithered_image = v

    @property
    def display_state(self):
        return self.vm.display_state

    @display_state.setter
    def display_state(self, v):
        self.vm.display_state = v

    @property
    def video_path(self):
        return self.vm.video_path

    @video_path.setter
    def video_path(self, v):
        self.vm.video_path = v

    @property
    def last_palette(self):
        return self.vm.last_palette

    @property
    def last_gamma(self):
        return self.vm.last_gamma

    @property
    def dither_parameters(self):
        return self.vm.dither_parameters

    def _sync_vm(self):
        """Push the tk variable values into the view-model settings."""
        self.vm.mode = self.mode_var.get()
        try:
            self.vm.num_colors = int(self.colors_var.get())
        except Exception:
            pass
        self.vm.use_gamma = bool(self.gamma_var.get())
        try:
            self.vm.pixelize_max_size = int(self.max_size_var.get())
        except Exception:
            pass
        try:
            self.vm.final_resize_multiplier = max(1, int(self.resize_var.get()))
        except Exception:
            self.vm.final_resize_multiplier = 1

    # ------------------------------------------------------------------ UI

    def _apply_theme(self):
        """Honor the persisted theme.appearance_mode key (the original
        application feeds the same key to customtkinter's
        set_appearance_mode). Plain ttk here, so the mode
        maps to a ttk.Style palette; the decision (mode -> colors,
        system/unknown fallbacks) lives headlessly testable in
        gui/viewmodel.py:theme_palette."""
        pal = theme_palette(self.config.get("theme", "appearance_mode",
                                            default="dark"))
        self.theme = pal
        style = ttk.Style(self.root)
        try:
            # clam is the one built-in theme that honors background maps on
            # every widget class used here.
            style.theme_use("clam")
        except tk.TclError:
            pass
        self.root.configure(background=pal["bg"])
        style.configure(".", background=pal["bg"], foreground=pal["fg"],
                        fieldbackground=pal["field"])
        for cls in ("TFrame", "TLabel", "TCheckbutton", "TRadiobutton",
                    "TLabelframe", "TLabelframe.Label"):
            style.configure(cls, background=pal["bg"], foreground=pal["fg"])
        style.configure("TButton", background=pal["button"],
                        foreground=pal["fg"])
        style.map("TButton", background=[("active", pal["accent"])])
        for cls in ("TEntry", "TCombobox", "TSpinbox"):
            style.configure(cls, fieldbackground=pal["field"],
                            foreground=pal["fg"],
                            insertcolor=pal["fg"])

    def _build_ui(self):
        outer = ttk.Frame(self.root)
        outer.pack(fill="both", expand=True)

        sidebar = ttk.Frame(outer, width=220)
        sidebar.pack(side="left", fill="y", padx=6, pady=6)

        def btn(text, cmd):
            b = ttk.Button(sidebar, text=text, command=cmd)
            b.pack(fill="x", pady=2)
            return b

        btn("Open Image...", self.open_image)
        btn("Open Video...", self.open_video)
        btn("Random Video Frame", self.random_video_frame)
        ttk.Separator(sidebar).pack(fill="x", pady=4)

        ttk.Label(sidebar, text="Pixelize max size").pack(anchor="w")
        self.max_size_var = tk.IntVar(value=self.vm.pixelize_max_size)
        ttk.Entry(sidebar, textvariable=self.max_size_var, width=8).pack(anchor="w")
        btn("Pixelize (regular)", self.pixelize_regular_action)
        btn("Pixelize (neural)", self.pixelize_neural_action)
        btn("Pixel Editor...", self.open_pixel_editor)
        ttk.Separator(sidebar).pack(fill="x", pady=4)

        ttk.Label(sidebar, text="Dither mode").pack(anchor="w")
        mode_row = ttk.Frame(sidebar)
        mode_row.pack(fill="x")
        self.mode_var = tk.StringVar(value=self.vm.mode)
        self.mode_combo = ttk.Combobox(
            mode_row, textvariable=self.mode_var, state="readonly",
            values=[m.value for m in DitherMode], width=16)
        self.mode_combo.pack(side="left", fill="x", expand=True)
        ttk.Button(mode_row, text="⚙", width=3,
                   command=self.open_mode_settings).pack(side="left", padx=2)

        ttk.Label(sidebar, text="Colors").pack(anchor="w", pady=(4, 0))
        self.colors_var = tk.IntVar(value=self.vm.num_colors)
        ttk.Entry(sidebar, textvariable=self.colors_var, width=8).pack(anchor="w")

        self.gamma_var = tk.BooleanVar(value=self.vm.use_gamma)
        ttk.Checkbutton(sidebar, text="Gamma correction",
                        variable=self.gamma_var).pack(anchor="w", pady=2)

        ttk.Label(sidebar, text="Final resize ×").pack(anchor="w", pady=(4, 0))
        self.resize_var = tk.IntVar(value=self.vm.final_resize_multiplier)
        self.resize_var.trace_add("write", lambda *a: self._update_size_note())
        ttk.Entry(sidebar, textvariable=self.resize_var, width=8).pack(anchor="w")
        self.size_note = ttk.Label(sidebar, text="", foreground="#888")
        self.size_note.pack(anchor="w")

        ttk.Separator(sidebar).pack(fill="x", pady=4)
        btn("Apply Dithering...", self.apply_dithering_dialog)
        btn("Apply to Video...", self.apply_to_video)
        btn("Save Result...", self.save_result)
        ttk.Separator(sidebar).pack(fill="x", pady=4)
        btn("Import Lospec Palette...", self.import_lospec)
        btn("Palette from Image...", self.palette_from_image)
        btn("Create Palette...", self.create_palette)
        ttk.Separator(sidebar).pack(fill="x", pady=4)
        btn("Fit to Window", lambda: self.viewer.fit_image())
        btn("Toggle View", self.toggle_view)
        btn("Compare...", self.compare_views)

        self.viewer = ZoomableImage(outer, bg=self.theme["canvas"])
        self.viewer.pack(side="left", fill="both", expand=True)

        self.status = StatusBar(self.root,
                                spinner=self.config.get("ui", "spinner",
                                                        default="dots"))
        self.status.pack(fill="x", side="bottom")

    # ------------------------------------------------------------- helpers

    def _active_source(self) -> Optional[Image.Image]:
        return self.vm.active_source()

    def _show(self, image: Image.Image, state: str, keep_view=True):
        view = self.viewer.get_view_state()
        self.viewer.set_image(image, keep_view=keep_view)
        if keep_view:
            self.viewer.set_view_state(view)
        self.display_state = state
        self._update_size_note()

    def _update_size_note(self):
        self._sync_vm()
        note = self.vm.result_size_note()
        if note:
            self.size_note.config(text=note)

    def _params_for_mode(self, mode: str) -> Dict[str, Any]:
        self._sync_vm()
        return self.vm.params_for_mode(mode)

    def _build_ditherer(self, palette, num_colors) -> ImageDitherer:
        self._sync_vm()
        return self.vm.build_ditherer(palette, num_colors)

    # ---------------------------------------------------------- file ops

    def open_image(self):
        path = filedialog.askopenfilename(
            initialdir=self.config.get_last_dir("image") or ".",
            filetypes=[("Images", " ".join(f"*{e}" for e in IMAGE_EXTENSIONS))])
        if not path:
            return
        img = self.vm.load_image(path)
        self._show(img, "current", keep_view=False)
        self.status.set_text(f"Loaded {Path(path).name} "
                             f"({img.size[0]}x{img.size[1]})")

    def open_video(self):
        path = filedialog.askopenfilename(
            initialdir=self.config.get_last_dir("video") or ".",
            filetypes=[("Videos", " ".join(f"*{e}" for e in VIDEO_EXTENSIONS))])
        if not path:
            return
        from dither_pie_tpu_torch.pipeline import ffio

        if not ffio.video_available():
            messagebox.showerror("No video backend",
                                 "Video support requires ffmpeg (or OpenCV).")
            return
        try:
            img = self.vm.load_video(path)
        except ValueError as e:
            messagebox.showerror("Error", str(e))
            return
        self._show(img, "current", keep_view=False)
        self.status.set_text(f"Loaded video {Path(path).name} (first frame)")

    def random_video_frame(self):
        if not self.video_path:
            messagebox.showinfo("No video", "Open a video first.")
            return
        try:
            img, idx, n = self.vm.random_video_frame()
        except ValueError as e:
            messagebox.showerror("Error", str(e))
            return
        self._show(img, "current", keep_view=False)
        self.status.set_text(f"Frame {idx}/{n}")

    def save_result(self):
        self._sync_vm()
        img = self.vm.result_image()
        if img is None:
            messagebox.showinfo("Nothing to save", "Process an image first.")
            return
        path = filedialog.asksaveasfilename(defaultextension=".png",
                                            filetypes=[("PNG", "*.png")])
        if path:
            img.save(path)
            self.status.set_text(f"Saved {Path(path).name}")

    # ------------------------------------------------------- pixelization

    def pixelize_regular_action(self):
        if self.current_image is None:
            return
        self._sync_vm()
        img = self.vm.pixelize("regular")
        self._show(img, "pixelized", keep_view=False)
        self.status.set_text(f"Pixelized to {img.size[0]}x{img.size[1]}")

    def pixelize_neural_action(self):
        if self.current_image is None:
            return
        self._sync_vm()
        cached = self.vm.cached_pixelize("neural")
        if cached is not None:
            self.vm.set_pixelized(cached)
            self._show(cached, "pixelized", keep_view=False)
            return
        self.status.start_spinner("Neural pixelization...")

        def work():
            try:
                result = self.vm.pixelize("neural")
                def done():
                    self._show(result, "pixelized", keep_view=False)
                    self.status.stop_spinner("Neural pixelization complete")
                self.root.after(0, done)
            except Exception as e:
                self.root.after(0, lambda: (
                    self.status.stop_spinner("Neural pixelization failed"),
                    messagebox.showerror("Neural pixelization", str(e))))

        threading.Thread(target=work, daemon=True).start()

    def open_pixel_editor(self):
        if self.current_image is None:
            return

        def apply(img):
            self.vm.set_pixelized(img)
            self._show(img, "pixelized", keep_view=False)

        PixelizationEditorDialog(self.root, self._active_source(),
                                 target_size=int(self.max_size_var.get()),
                                 on_apply=apply, config_mgr=self.config,
                                 canvas_bg=self.theme["canvas"])

    # ------------------------------------------------------------ dither

    def open_mode_settings(self):
        mode = self.mode_var.get()
        info = ImageDitherer.get_mode_parameters(DitherMode(mode))
        if not info:
            messagebox.showinfo("No settings", f"'{mode}' has no parameters.")
            return

        def on_change(values):
            self.dither_parameters[mode] = values

        dlg = DitherSettingsDialog(self.root, mode, info,
                                   self.dither_parameters.get(mode, {}),
                                   on_change=on_change)
        self.root.wait_window(dlg)
        if dlg.result is not None:
            self.dither_parameters[mode] = dlg.result

    def _palette_options(self, source_img: Image.Image):
        """(label, palette) choices: generated + palette.json entries."""
        self._sync_vm()
        return self.vm.palette_options(source_img)

    def apply_dithering_dialog(self):
        src = self._active_source()
        if src is None:
            messagebox.showinfo("No image", "Open an image first.")
            return
        PaletteDialog(self, src)

    # ------------------------------------------------------------- video

    def apply_to_video(self):
        if not self.video_path:
            messagebox.showinfo("No video", "Open a video first.")
            return
        if self.last_palette is None:
            messagebox.showinfo("No palette",
                                "Apply dithering to the preview frame first "
                                "(the same palette is used for the video).")
            return
        out = filedialog.asksaveasfilename(defaultextension=".mp4",
                                           filetypes=[("MP4", "*.mp4")])
        if not out:
            return
        self._sync_vm()
        dlg = ProgressDialog(self.root, "Processing video")

        def work():
            ok = self.vm.apply_to_video(out,
                                        progress_callback=dlg.update_progress)
            self.root.after(0, dlg.close)
            msg = "Video processed!" if ok else "Video processing failed"
            self.root.after(0, lambda: self.status.set_text(msg))

        threading.Thread(target=work, daemon=True).start()

    # ----------------------------------------------------------- palettes

    def import_lospec(self):
        url = simpledialog.askstring("Lospec import",
                                     "Palette URL (lospec.com/palette-list/...):",
                                     parent=self.root)
        if not url:
            return
        pal = self.vm.import_lospec(url)
        if pal is None:
            messagebox.showerror("Import failed", "Could not fetch palette.")
            return
        self.status.set_text(f"Imported palette '{pal['name']}' "
                             f"({len(pal['colors'])} colors)")

    def palette_from_image(self):
        # Confirm-or-retry loop with the preview dialog (the original
        # application's flow: dither_pie_gui.py:1652-1717 +
        # PaletteImagePreviewDialog).
        while True:
            path = filedialog.askopenfilename(
                filetypes=[("Images",
                            " ".join(f"*{e}" for e in IMAGE_EXTENSIONS))])
            if not path:
                return
            self._sync_vm()
            palette = self.vm.kmeans_palette_from_image(path)
            dlg = PaletteImagePreviewDialog(self.root, palette, path,
                                            int(self.vm.num_colors))
            self.root.wait_window(dlg)
            if dlg.use_result:
                break
            if not dlg.choose_another:
                return  # closed without choosing
        name = simpledialog.askstring("Palette name", "Save palette as:",
                                      initialvalue=Path(path).stem, parent=self.root)
        if name:
            self.vm.save_palette(name, palette)
            self.status.set_text(f"Saved palette '{name}'")

    def create_palette(self):
        def save(pal):
            self.vm.save_palette(pal["name"], pal["colors"])
            self.status.set_text(f"Saved palette '{pal['name']}'")

        CustomPaletteCreator(self.root, on_save=save)

    # -------------------------------------------------------------- misc

    def compare_views(self):
        """Side-by-side original vs latest processed result."""
        processed = self.dithered_image or self.pixelized_image
        if self.current_image is None or processed is None:
            messagebox.showinfo("Nothing to compare",
                                "Process an image first.")
            return
        ImageComparisonView(self.root, self.current_image, processed,
                            canvas_bg=self.theme["canvas"])

    def toggle_view(self):
        res = self.vm.toggle_state()
        if res is None:
            return
        name, img = res
        self._show(img, name, keep_view=True)
        self.status.set_text(f"Showing: {name}")

    def _on_close(self):
        try:
            self.config.set_window_geometry(self.root.geometry())
            self._sync_vm()
            self.vm.persist_settings()
        except Exception:
            pass
        self.root.destroy()

    def run(self):
        self.root.mainloop()


class PaletteDialog(tk.Toplevel):
    """Palette chooser with live preview rendered into the main viewer.

    Previews generate on a background thread into a 30-entry LRU cache keyed
    (palette, gamma, mode, params); selecting 'Apply Selected' adopts the
    cached preview as the dithered image and records palette/gamma for a
    later 'Apply to Video'."""

    def __init__(self, app: DitheringApp, source_img: Image.Image):
        super().__init__(app.root)
        self.title("Choose palette")
        self.app = app
        self.source_img = source_img
        self.options = app._palette_options(source_img)
        self.var = tk.IntVar(value=0)
        self._saved_view = app.viewer.get_view_state()

        canvas = tk.Canvas(self, width=330, height=460,
                           highlightthickness=0,
                           bg=app.theme.get("canvas", "#1e1e1e"))
        scroll = ttk.Scrollbar(self, orient="vertical", command=canvas.yview)
        inner = ttk.Frame(canvas)
        inner.bind("<Configure>",
                   lambda e: canvas.configure(scrollregion=canvas.bbox("all")))
        canvas.create_window((0, 0), window=inner, anchor="nw")
        canvas.configure(yscrollcommand=scroll.set)
        canvas.pack(side="left", fill="both", expand=True)
        scroll.pack(side="left", fill="y")

        for i, (label, colors) in enumerate(self.options):
            row = ttk.Frame(inner)
            row.pack(fill="x", pady=2, padx=4)
            ttk.Radiobutton(row, text=label, value=i, variable=self.var,
                            command=self._on_select).pack(anchor="w")
            PalettePreview(row, colors).pack(anchor="w")

        btns = ttk.Frame(self)
        btns.pack(side="bottom", fill="x", pady=6)
        ttk.Button(btns, text="Toggle Original",
                   command=self._toggle_original).pack(side="left", padx=4)
        ttk.Button(btns, text="Apply Selected",
                   command=self._apply).pack(side="right", padx=4)
        ttk.Button(btns, text="Cancel", command=self._cancel).pack(side="right")

        self._showing_original = False
        self._on_select()

    def _cache_key(self) -> str:
        label, colors = self.options[self.var.get()]
        self.app._sync_vm()
        return self.app.vm.preview_cache_key(label, colors)

    def _on_select(self):
        vm = self.app.vm
        key = self._cache_key()
        cached = vm.get_cached_preview(key)
        if cached is not None:
            self._display(cached)
            return
        self.app.status.start_spinner("Generating preview...")
        gen = vm.begin_preview()
        label, colors = self.options[self.var.get()]
        src = self.source_img

        def work():
            try:
                preview = vm.render_preview(label, colors, src)
            except Exception as e:
                self.app.root.after(0, lambda: self.app.status.stop_spinner(
                    f"Preview failed: {e}"))
                return

            def done():
                if not vm.commit_preview(gen, key, preview):
                    return  # superseded by a newer selection
                self._display(preview)
                self.app.status.stop_spinner("Preview ready")

            self.app.root.after(0, done)

        threading.Thread(target=work, daemon=True).start()

    def _display(self, img: Image.Image):
        view = self.app.viewer.get_view_state()
        self.app.viewer.set_image(img, keep_view=True)
        self.app.viewer.set_view_state(view)
        self._showing_original = False

    def _toggle_original(self):
        if self._showing_original:
            cached = self.app.vm.get_cached_preview(self._cache_key())
            if cached is not None:
                self._display(cached)
        else:
            view = self.app.viewer.get_view_state()
            self.app.viewer.set_image(self.source_img, keep_view=True)
            self.app.viewer.set_view_state(view)
            self._showing_original = True

    def _apply(self):
        key = self._cache_key()
        label, colors = self.options[self.var.get()]
        preview = self.app.vm.get_cached_preview(key)
        if preview is None:
            messagebox.showinfo("Preview pending",
                                "Wait for the preview to finish.")
            return
        self.app.vm.adopt_preview(colors, preview)
        self.app._show(preview, "dithered", keep_view=True)
        self.app.status.set_text(f"Dithered with '{label}'")
        self.destroy()

    def _cancel(self):
        self.app.viewer.set_view_state(self._saved_view)
        src = self.app.dithered_image or self.app._active_source()
        if src is not None:
            self.app.viewer.set_image(src, keep_view=True)
        self.destroy()


def launch_gui(device: DeviceLike = "cuda"):
    """Open the app on ``device`` and run its main loop. The device is
    resolved before the window is built: without the card (or without a
    display) this exits 1 with a message that names the command line, and
    nothing carries on on the CPU."""
    try:
        device = resolve_device(device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"Cannot start GUI on {str(device)!r} ({e}). "
                         f"Use the command line: {CLI_HINT}")
    try:
        app = DitheringApp(device=device)
    except tk.TclError as e:
        raise SystemExit(f"Cannot start GUI ({e}). On a headless machine use the "
                         f"command line: {CLI_HINT}")
    app.run()
