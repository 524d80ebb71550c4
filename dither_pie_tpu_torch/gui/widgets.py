"""GUI widgets (tkinter/ttk): functional equivalents of the original
application's customtkinter widget set (its ``gui_components.py``), as the
JAX package's ``dither_pie_tpu/gui/widgets.py`` has them: zoomable viewer,
palette previews, progress dialog, spinner status bar, HSV picker, custom
palette creator, metadata-driven dither settings dialog, and the
pixelization editor canvas (grid, brush, flood fill, undo/redo).

customtkinter is not a dependency, so everything is plain tk/ttk. The pure
functions (``clamp_parameters``, ``sample_grid_from_image``,
``sample_grid_with_geometry``) live in ``gui/logic.py``, which imports no
tkinter, and are re-exported here under the JAX package's names.
"""

from __future__ import annotations

import colorsys
import json
import tkinter as tk
from pathlib import Path
from tkinter import colorchooser, ttk
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
from PIL import Image, ImageTk

from dither_pie_tpu_torch.gui.logic import (  # noqa: F401  (the JAX package's names)
    clamp_parameters, sample_grid_from_image, sample_grid_with_geometry)
from dither_pie_tpu_torch.utils import compute_even_dimensions, hex_to_rgb, rgb_to_hex

_SPINNERS_JSON = Path(__file__).resolve().parents[1] / "assets" / "spinners.json"


class ZoomableImage(tk.Canvas):
    """Zoom/pan image canvas with NEAREST resampling (pixel-art friendly).

    Mouse wheel zooms (Shift = fine steps), drag pans, ``fit_image`` resets.
    """

    MIN_ZOOM, MAX_ZOOM = 0.05, 64.0

    def __init__(self, master, **kwargs):
        # Default dark surface; the app passes bg=theme["canvas"] so the
        # viewer follows theme.appearance_mode (gui/app.py:_apply_theme).
        kwargs.setdefault("bg", "#202020")
        super().__init__(master, highlightthickness=0, **kwargs)
        self.original: Optional[Image.Image] = None
        self._tk_img = None
        self.zoom = 1.0
        self.offset = [0.0, 0.0]
        self._drag_start = None
        self.bind("<ButtonPress-1>", self._on_press)
        self.bind("<B1-Motion>", self._on_drag)
        self.bind("<MouseWheel>", self._on_wheel)
        # X11 delivers wheel events as Button-4/5; route through
        # _on_wheel_step so subclasses can override wheel behavior once.
        self.bind("<Button-4>", lambda e: self._on_wheel_step(e, 1))
        self.bind("<Button-5>", lambda e: self._on_wheel_step(e, -1))
        self.bind("<Configure>", lambda e: self.redraw())

    def set_image(self, image: Image.Image, keep_view: bool = False):
        self.original = image
        if not keep_view:
            self.fit_image()
        else:
            self.redraw()

    def get_view_state(self) -> Tuple[float, List[float]]:
        return self.zoom, list(self.offset)

    def set_view_state(self, state):
        self.zoom, self.offset = state[0], list(state[1])
        self.redraw()

    def fit_image(self):
        if self.original is None:
            return
        cw = max(self.winfo_width(), 1)
        ch = max(self.winfo_height(), 1)
        iw, ih = self.original.size
        self.zoom = max(min(cw / iw, ch / ih), self.MIN_ZOOM)
        self.offset = [(cw - iw * self.zoom) / 2, (ch - ih * self.zoom) / 2]
        self.redraw()

    def _on_press(self, e):
        self._drag_start = (e.x, e.y, *self.offset)

    def _on_drag(self, e):
        if self._drag_start:
            x0, y0, ox, oy = self._drag_start
            self.offset = [ox + e.x - x0, oy + e.y - y0]
            self.redraw()

    def _on_wheel(self, e):
        self._on_wheel_step(e, 1 if e.delta > 0 else -1)

    def _on_wheel_step(self, e, direction: int):
        """Single overridable wheel handler (covers <MouseWheel> and the
        X11 Button-4/5 events). Shift = fine zoom."""
        if direction > 0:
            factor = 1.05 if e.state & 0x0001 else 1.25
        else:
            factor = 0.95 if e.state & 0x0001 else 0.8
        self._zoom_at(e.x, e.y, factor)

    def _zoom_at(self, x, y, factor):
        new_zoom = min(max(self.zoom * factor, self.MIN_ZOOM), self.MAX_ZOOM)
        scale = new_zoom / self.zoom
        self.offset = [x - (x - self.offset[0]) * scale,
                       y - (y - self.offset[1]) * scale]
        self.zoom = new_zoom
        self.redraw()

    def redraw(self):
        self.delete("all")
        if self.original is None:
            return
        iw, ih = self.original.size
        vw = max(int(iw * self.zoom), 1)
        vh = max(int(ih * self.zoom), 1)
        # Render only at display scale (NEAREST keeps pixels crisp).
        img = self.original.resize((vw, vh), Image.Resampling.NEAREST)
        self._tk_img = ImageTk.PhotoImage(img)
        self.create_image(self.offset[0], self.offset[1],
                          image=self._tk_img, anchor="nw")


class PalettePreview(tk.Canvas):
    """Horizontal color-bar preview of a palette."""

    def __init__(self, master, colors: List[Tuple[int, int, int]],
                 width=240, height=22, **kwargs):
        super().__init__(master, width=width, height=height,
                         highlightthickness=1, highlightbackground="#555",
                         **kwargs)
        self.set_colors(colors)

    def set_colors(self, colors):
        self.delete("all")
        if not colors:
            return
        w = int(self["width"])
        h = int(self["height"])
        step = w / len(colors)
        for i, c in enumerate(colors):
            self.create_rectangle(i * step, 0, (i + 1) * step, h,
                                  fill=rgb_to_hex(tuple(c)), outline="")


class ProgressDialog(tk.Toplevel):
    """Modal progress window compatible with the (fraction, message)
    callback protocol."""

    def __init__(self, master, title="Processing..."):
        super().__init__(master)
        self.title(title)
        self.geometry("420x110")
        self.transient(master)
        self.resizable(False, False)
        self.label = ttk.Label(self, text="Starting...")
        self.label.pack(pady=(16, 6), padx=16, anchor="w")
        self.bar = ttk.Progressbar(self, length=380, mode="determinate",
                                   maximum=100)
        self.bar.pack(padx=16, pady=4)
        self.protocol("WM_DELETE_WINDOW", lambda: None)

    def update_progress(self, fraction: float, message: str):
        def _apply():
            self.bar["value"] = fraction * 100
            self.label.config(text=message)
        self.after(0, _apply)

    def close(self):
        self.after(0, self.destroy)


class StatusBar(ttk.Frame):
    """Status line with JSON-defined spinner animations
    (assets/spinners.json, cli-spinners format {name: {interval, frames}})."""

    def __init__(self, master, spinner: str = "dots", **kwargs):
        super().__init__(master, **kwargs)
        self.label = ttk.Label(self, text="Ready")
        self.label.pack(side="left", padx=8)
        try:
            spinners = json.loads(_SPINNERS_JSON.read_text())
        except Exception:
            spinners = {}
        self._spinner = spinners.get(spinner) or {"interval": 80,
                                                  "frames": ["-", "\\", "|", "/"]}
        self._spinning = False
        self._frame_idx = 0

    def set_text(self, text: str):
        self._spinning = False
        self.label.config(text=text)

    def start_spinner(self, text: str):
        self._spinning = True
        self._base_text = text
        self._tick()

    def stop_spinner(self, text: str = "Ready"):
        self._spinning = False
        self.label.config(text=text)

    def _tick(self):
        if not self._spinning:
            return
        frames = self._spinner["frames"]
        frame = frames[self._frame_idx % len(frames)]
        self._frame_idx += 1
        self.label.config(text=f"{frame} {self._base_text}")
        self.after(self._spinner.get("interval", 80), self._tick)


class ImageComparisonView(tk.Toplevel):
    """Side-by-side before/after viewer."""

    def __init__(self, master, left: Image.Image, right: Image.Image,
                 titles=("Original", "Processed"), canvas_bg=None):
        super().__init__(master)
        self.title("Comparison")
        for col, (img, name) in enumerate(zip((left, right), titles)):
            frame = ttk.Frame(self)
            frame.grid(row=0, column=col, sticky="nsew")
            ttk.Label(frame, text=name).pack()
            viewer = ZoomableImage(frame, width=420, height=420,
                                   **({"bg": canvas_bg} if canvas_bg else {}))
            viewer.pack(fill="both", expand=True)
            viewer.set_image(img)
        self.columnconfigure(0, weight=1)
        self.columnconfigure(1, weight=1)
        self.rowconfigure(0, weight=1)


class HSVColorPickerDialog(tk.Toplevel):
    """Hue slider + saturation/value plane + RGB/hex entry."""

    PLANE = 200

    def __init__(self, master, initial=(255, 0, 0), on_pick=None):
        super().__init__(master)
        self.title("Pick color")
        self.resizable(False, False)
        self.on_pick = on_pick
        self.result: Optional[Tuple[int, int, int]] = None
        r, g, b = [v / 255 for v in initial]
        self.h, self.s, self.v = colorsys.rgb_to_hsv(r, g, b)

        self.plane = tk.Canvas(self, width=self.PLANE, height=self.PLANE,
                               highlightthickness=1)
        self.plane.grid(row=0, column=0, padx=8, pady=8)
        self.plane.bind("<B1-Motion>", self._on_plane)
        self.plane.bind("<ButtonPress-1>", self._on_plane)

        self.hue = tk.Scale(self, from_=0, to=359, orient="vertical",
                            command=self._on_hue, showvalue=False, length=self.PLANE)
        self.hue.set(int(self.h * 359))
        self.hue.grid(row=0, column=1, padx=4, pady=8)

        entry_frame = ttk.Frame(self)
        entry_frame.grid(row=1, column=0, columnspan=2, pady=(0, 8))
        ttk.Label(entry_frame, text="Hex:").pack(side="left")
        self.hex_var = tk.StringVar(value=rgb_to_hex(initial))
        hex_entry = ttk.Entry(entry_frame, textvariable=self.hex_var, width=9)
        hex_entry.pack(side="left", padx=4)
        hex_entry.bind("<Return>", self._on_hex)
        self.swatch = tk.Canvas(entry_frame, width=40, height=20,
                                highlightthickness=1)
        self.swatch.pack(side="left", padx=4)
        ttk.Button(entry_frame, text="OK", command=self._ok).pack(side="left", padx=4)
        ttk.Button(entry_frame, text="Cancel",
                   command=self.destroy).pack(side="left")
        self._render_plane()
        self._update_swatch()

    def _current_rgb(self):
        r, g, b = colorsys.hsv_to_rgb(self.h, self.s, self.v)
        return (int(r * 255), int(g * 255), int(b * 255))

    def _render_plane(self):
        n = 40  # coarse grid; rendered as rectangles for tk performance
        self.plane.delete("all")
        cell = self.PLANE / n
        for i in range(n):
            for j in range(n):
                s, v = i / (n - 1), 1 - j / (n - 1)
                r, g, b = colorsys.hsv_to_rgb(self.h, s, v)
                color = rgb_to_hex((int(r * 255), int(g * 255), int(b * 255)))
                self.plane.create_rectangle(i * cell, j * cell,
                                            (i + 1) * cell, (j + 1) * cell,
                                            fill=color, outline="")

    def _on_plane(self, e):
        self.s = min(max(e.x / self.PLANE, 0), 1)
        self.v = 1 - min(max(e.y / self.PLANE, 0), 1)
        self._update_swatch()

    def _on_hue(self, val):
        self.h = int(val) / 359
        self._render_plane()
        self._update_swatch()

    def _on_hex(self, _e):
        try:
            r, g, b = hex_to_rgb(self.hex_var.get())
            self.h, self.s, self.v = colorsys.rgb_to_hsv(r / 255, g / 255, b / 255)
            self.hue.set(int(self.h * 359))
            self._render_plane()
            self._update_swatch()
        except Exception:
            pass

    def _update_swatch(self):
        rgb = self._current_rgb()
        self.hex_var.set(rgb_to_hex(rgb))
        self.swatch.delete("all")
        self.swatch.create_rectangle(0, 0, 40, 20, fill=rgb_to_hex(rgb), outline="")

    def _ok(self):
        self.result = self._current_rgb()
        if self.on_pick:
            self.on_pick(self.result)
        self.destroy()


class ColorPickerGrid(ttk.Frame):
    """Click-to-edit grid of palette color swatches."""

    def __init__(self, master, colors: List[Tuple[int, int, int]],
                 on_change: Optional[Callable] = None, columns=8):
        super().__init__(master)
        self.colors = [tuple(c) for c in colors]
        self.on_change = on_change
        self.columns = columns
        self._render()

    def _render(self):
        for child in self.winfo_children():
            child.destroy()
        for i, c in enumerate(self.colors):
            sw = tk.Canvas(self, width=28, height=28, highlightthickness=1,
                           highlightbackground="#333")
            sw.create_rectangle(0, 0, 28, 28, fill=rgb_to_hex(c), outline="")
            sw.grid(row=i // self.columns, column=i % self.columns, padx=2, pady=2)
            sw.bind("<Button-1>", lambda e, idx=i: self._edit(idx))

    def _edit(self, idx):
        def picked(rgb):
            self.colors[idx] = rgb
            self._render()
            if self.on_change:
                self.on_change(self.colors)
        HSVColorPickerDialog(self, initial=self.colors[idx], on_pick=picked)


class CustomPaletteCreator(tk.Toplevel):
    """Create/edit a named palette; returns {'name', 'colors': [#hex]}."""

    def __init__(self, master, name="custom", colors=None, on_save=None):
        super().__init__(master)
        self.title("Custom palette")
        self.on_save = on_save
        self.name_var = tk.StringVar(value=name)
        self.colors = [tuple(c) for c in (colors or [(0, 0, 0), (255, 255, 255)])]
        top = ttk.Frame(self)
        top.pack(fill="x", padx=8, pady=8)
        ttk.Label(top, text="Name:").pack(side="left")
        ttk.Entry(top, textvariable=self.name_var, width=20).pack(side="left", padx=4)
        self.grid_frame = ColorPickerGrid(self, self.colors,
                                          on_change=self._set_colors)
        self.grid_frame.pack(padx=8, pady=4)
        btns = ttk.Frame(self)
        btns.pack(pady=8)
        ttk.Button(btns, text="Add color", command=self._add).pack(side="left", padx=4)
        ttk.Button(btns, text="Remove last", command=self._pop).pack(side="left", padx=4)
        ttk.Button(btns, text="Save", command=self._save).pack(side="left", padx=4)
        ttk.Button(btns, text="Cancel", command=self.destroy).pack(side="left", padx=4)

    def _set_colors(self, colors):
        self.colors = colors

    def _add(self):
        self.colors.append((128, 128, 128))
        self.grid_frame.colors = self.colors
        self.grid_frame._render()

    def _pop(self):
        if len(self.colors) > 2:
            self.colors.pop()
            self.grid_frame.colors = self.colors
            self.grid_frame._render()

    def _save(self):
        if self.on_save:
            self.on_save({"name": self.name_var.get(),
                          "colors": [rgb_to_hex(c) for c in self.colors]})
        self.destroy()


class DitherSettingsDialog(tk.Toplevel):
    """Metadata-driven parameter editor.

    Auto-builds int/float/choice widgets from ``get_parameter_info()``
    metadata (the same dicts the CLI consumes), clamps to min/max, debounces
    live-change callbacks (250 ms), and offers reset-to-defaults — matching
    the reference's dialog behavior (gui_components.py:1330-1601).
    """

    DEBOUNCE_MS = 250

    def __init__(self, master, mode_name: str, param_info: Dict[str, Any],
                 current: Dict[str, Any], on_change: Optional[Callable] = None):
        super().__init__(master)
        self.title(f"{mode_name} settings")
        self.param_info = param_info
        self.on_change = on_change
        self.vars: Dict[str, tk.Variable] = {}
        self._after_id = None
        self.result: Optional[Dict[str, Any]] = None

        body = ttk.Frame(self)
        body.pack(fill="both", expand=True, padx=10, pady=10)
        for row, (key, info) in enumerate(param_info.items()):
            ttk.Label(body, text=info.get("label", key)).grid(
                row=row, column=0, sticky="w", pady=3)
            value = current.get(key, info["default"])
            if info["type"] == "choice":
                var = tk.StringVar(value=str(value))
                widget = ttk.Combobox(body, textvariable=var, state="readonly",
                                      values=[str(c) for c in info["choices"]],
                                      width=14)
                widget.bind("<<ComboboxSelected>>", lambda e: self._changed())
            else:
                var = tk.StringVar(value=str(value))
                widget = ttk.Entry(body, textvariable=var, width=10)
                widget.bind("<KeyRelease>", lambda e: self._changed())
            widget.grid(row=row, column=1, sticky="w", padx=6)
            if "description" in info:
                ttk.Label(body, text=info["description"], foreground="#888",
                          wraplength=260).grid(row=row, column=2, sticky="w")
            self.vars[key] = var

        btns = ttk.Frame(self)
        btns.pack(pady=(0, 10))
        ttk.Button(btns, text="Reset to defaults",
                   command=self._reset).pack(side="left", padx=4)
        ttk.Button(btns, text="OK", command=self._ok).pack(side="left", padx=4)
        ttk.Button(btns, text="Cancel", command=self.destroy).pack(side="left", padx=4)

    def current_values(self) -> Dict[str, Any]:
        return clamp_parameters(self.param_info,
                                {k: v.get() for k, v in self.vars.items()})

    def _changed(self):
        if self._after_id:
            self.after_cancel(self._after_id)
        self._after_id = self.after(self.DEBOUNCE_MS, self._fire)

    def _fire(self):
        self._after_id = None
        if self.on_change:
            self.on_change(self.current_values())

    def _reset(self):
        for key, info in self.param_info.items():
            self.vars[key].set(str(info["default"]))
        self._changed()

    def _ok(self):
        self.result = self.current_values()
        self.destroy()


class PixelizationEditorCanvas(tk.Canvas):
    """Manual pixel-editing canvas: grid overlay, brush (with line
    interpolation), flood fill (RGB-distance threshold), color picker,
    undo/redo history."""

    def __init__(self, master, grid: np.ndarray, cell_px: int = 16, **kwargs):
        h, w = grid.shape[:2]
        kwargs.setdefault("bg", "#181818")
        super().__init__(master, width=w * cell_px, height=h * cell_px,
                         highlightthickness=0, **kwargs)
        self.grid_data = grid.astype(np.uint8).copy()
        self.cell_px = cell_px
        self.tool = "brush"  # brush | fill | picker
        self.brush_color = (0, 0, 0)
        self.fill_threshold = 32.0
        self.show_grid = True
        self.on_pick: Optional[Callable] = None
        self._history: List[np.ndarray] = [self.grid_data.copy()]
        self._redo: List[np.ndarray] = []
        self._last_cell = None
        self.bind("<ButtonPress-1>", self._on_press)
        self.bind("<B1-Motion>", self._on_drag)
        self.bind("<ButtonRelease-1>", lambda e: self._commit())
        self.redraw()

    # -- editing ops (pure array logic, unit-testable) --

    def paint_cell(self, row: int, col: int):
        h, w = self.grid_data.shape[:2]
        if 0 <= row < h and 0 <= col < w:
            self.grid_data[row, col] = self.brush_color

    def paint_line(self, r0, c0, r1, c1):
        """Bresenham interpolation between drag events."""
        dr, dc = abs(r1 - r0), abs(c1 - c0)
        sr = 1 if r1 > r0 else -1
        sc = 1 if c1 > c0 else -1
        err = dc - dr
        r, c = r0, c0
        while True:
            self.paint_cell(r, c)
            if (r, c) == (r1, c1):
                break
            e2 = 2 * err
            if e2 > -dr:
                err -= dr
                c += sc
            if e2 < dc:
                err += dc
                r += sr

    def flood_fill(self, row: int, col: int):
        h, w = self.grid_data.shape[:2]
        if not (0 <= row < h and 0 <= col < w):
            return
        target = self.grid_data[row, col].astype(np.float64)
        thr2 = self.fill_threshold ** 2
        visited = np.zeros((h, w), bool)
        stack = [(row, col)]
        while stack:
            r, c = stack.pop()
            if not (0 <= r < h and 0 <= c < w) or visited[r, c]:
                continue
            visited[r, c] = True
            d2 = float(np.sum((self.grid_data[r, c].astype(np.float64) - target) ** 2))
            if d2 > thr2:
                continue
            self.grid_data[r, c] = self.brush_color
            stack.extend([(r + 1, c), (r - 1, c), (r, c + 1), (r, c - 1)])

    def undo(self):
        if len(self._history) > 1:
            self._redo.append(self._history.pop())
            self.grid_data = self._history[-1].copy()
            self.redraw()

    def redo(self):
        if self._redo:
            state = self._redo.pop()
            self._history.append(state)
            self.grid_data = state.copy()
            self.redraw()

    # -- event plumbing --

    def _cell_of(self, e):
        return e.y // self.cell_px, e.x // self.cell_px

    def _on_press(self, e):
        r, c = self._cell_of(e)
        if self.tool == "picker":
            h, w = self.grid_data.shape[:2]
            if 0 <= r < h and 0 <= c < w:
                self.brush_color = tuple(int(v) for v in self.grid_data[r, c])
                if self.on_pick:
                    self.on_pick(self.brush_color)
            return
        if self.tool == "fill":
            self.flood_fill(r, c)
        else:
            self.paint_cell(r, c)
        self._last_cell = (r, c)
        self.redraw()

    def _on_drag(self, e):
        if self.tool != "brush":
            return
        r, c = self._cell_of(e)
        if self._last_cell and (r, c) != self._last_cell:
            self.paint_line(*self._last_cell, r, c)
            self._last_cell = (r, c)
            self.redraw()

    def _commit(self):
        if not np.array_equal(self.grid_data, self._history[-1]):
            self._history.append(self.grid_data.copy())
            self._redo.clear()

    def redraw(self):
        self.delete("all")
        h, w = self.grid_data.shape[:2]
        px = self.cell_px
        img = Image.fromarray(self.grid_data).resize((w * px, h * px),
                                                     Image.Resampling.NEAREST)
        self._tk_img = ImageTk.PhotoImage(img)
        self.create_image(0, 0, image=self._tk_img, anchor="nw")
        if self.show_grid and px >= 6:
            for c in range(w + 1):
                self.create_line(c * px, 0, c * px, h * px, fill="#404040")
            for r in range(h + 1):
                self.create_line(0, r * px, w * px, r * px, fill="#404040")


class PaletteImagePreviewDialog(tk.Toplevel):
    """Confirm-or-retry dialog for a palette generated from an image
    (the original application's gui_components.py:1283-1325): shows a color
    bar preview, sets ``use_result`` / ``choose_another`` for the caller."""

    def __init__(self, master, palette: List[Tuple[int, int, int]],
                 file_path: str, used_clusters: int):
        super().__init__(master)
        self.title("New Palette Preview")
        self.resizable(False, False)
        self.use_result = False
        self.choose_another = False
        self.transient(master)

        name = Path(file_path).name
        ttk.Label(self, justify="center",
                  text=(f"Generated a {used_clusters}-color palette from:\n"
                        f"{name}\n\nUse this palette or pick another image?")
                  ).pack(padx=12, pady=(10, 0))
        self.preview = PalettePreview(self, palette, width=300, height=30)
        self.preview.pack(pady=10)
        bf = ttk.Frame(self)
        bf.pack(pady=5, fill="x")
        ttk.Button(bf, text="Use This Palette", command=self._use
                   ).pack(side="left", expand=True, fill="x", padx=5, pady=5)
        ttk.Button(bf, text="Choose Another Image", command=self._retry
                   ).pack(side="right", expand=True, fill="x", padx=5, pady=5)
        self.grab_set()
        self.lift()
        self.focus_force()

    def _use(self):
        self.use_result = True
        self.destroy()

    def _retry(self):
        self.choose_another = True
        self.destroy()


class GridPreviewCanvas(ZoomableImage):
    """Pixelize-from-view preview: the source image with the sampling grid
    drawn over it. Normal wheel zooms the image (grid rides along, it lives
    in image space); Alt+wheel scales the GRID relative to the image and
    Alt+drag offsets it, for aligning the sampling grid with the artwork
    (reference Alt-zoom grid, gui_components.py:340-352)."""

    def __init__(self, master, source: Image.Image, target_size: int, **kw):
        super().__init__(master, **kw)
        self.alt_down = False
        self.grid_scale = 1.0
        self.grid_offset = [0.0, 0.0]  # source-pixel units
        self.target_size = target_size
        self.set_image(source)

    def set_target_size(self, target_size: int):
        self.target_size = target_size
        self.redraw()

    def _on_wheel_step(self, e, direction: int):
        if self.alt_down:
            factor = 1.05 if direction > 0 else 0.95
            self.grid_scale = min(max(self.grid_scale * factor, 0.1), 10.0)
            self.redraw()
        else:
            super()._on_wheel_step(e, direction)

    def _on_drag(self, e):
        if self.alt_down and self._drag_start:
            x0, y0, ox, oy = self._drag_start
            self.grid_offset[0] += (e.x - x0) / max(self.zoom, 1e-6)
            self.grid_offset[1] += (e.y - y0) / max(self.zoom, 1e-6)
            self._drag_start = (e.x, e.y, *self.offset)
            self.redraw()
        else:
            super()._on_drag(e)

    def grid_geometry(self):
        """(tw, th, cell_w, cell_h) of the sampling grid in source pixels."""
        w, h = self.original.size
        tw, th = compute_even_dimensions(w, h, self.target_size)
        return tw, th, w / tw * self.grid_scale, h / th * self.grid_scale

    def redraw(self):
        super().redraw()
        if self.original is None:
            return
        tw, th, cw, ch = self.grid_geometry()
        z = self.zoom
        ox = self.offset[0] + self.grid_offset[0] * z
        oy = self.offset[1] + self.grid_offset[1] * z
        if cw * z < 3 or ch * z < 3:
            return  # grid too dense to draw
        for c in range(tw + 1):
            x = ox + c * cw * z
            self.create_line(x, oy, x, oy + th * ch * z, fill="#d0d050")
        for r in range(th + 1):
            y = oy + r * ch * z
            self.create_line(ox, y, ox + tw * cw * z, y, fill="#d0d050")


class PixelizationEditorDialog(tk.Toplevel):
    """Pixelize-from-view editor (reference PixelizationEditorDialog,
    gui_components.py:1604-2106): preview stage with an alignable sampling
    grid (Alt-zoom/Alt-drag) -> Convert samples at adjusted cell centers ->
    edit stage (brush/fill/picker, Alt-hold temporary picker, Ctrl+Z/Y).
    Window geometry persists via the config manager."""

    def __init__(self, master, source: Image.Image, target_size: int = 48,
                 on_apply: Optional[Callable] = None, config_mgr=None,
                 canvas_bg: Optional[str] = None):
        super().__init__(master)
        self.title("Pixelization editor")
        self.on_apply = on_apply
        self.config_mgr = config_mgr
        self.canvas_bg = canvas_bg  # themed surface color (app passes
        #                             theme["canvas"]); None = widget default
        self.source = source.convert("RGB")
        self._alt_pick_active = False
        self._alt_prev_tool = None
        self._load_geometry()

        self.toolbar = ttk.Frame(self)
        self.toolbar.pack(fill="x", padx=6, pady=6)
        self.body = ttk.Frame(self)
        self.body.pack(fill="both", expand=True, padx=6, pady=6)

        self.preview: Optional[GridPreviewCanvas] = None
        self.canvas: Optional[PixelizationEditorCanvas] = None
        self._show_preview(target_size)

        self.bind("<Control-z>", lambda e: self.canvas and self.canvas.undo())
        self.bind("<Control-y>", lambda e: self.canvas and self.canvas.redo())
        self._alt_bind_ids = [
            (seq, self.bind_all(seq, cb, add="+"))
            for seq, cb in (("<KeyPress-Alt_L>", self._on_alt_down),
                            ("<KeyPress-Alt_R>", self._on_alt_down),
                            ("<KeyRelease-Alt_L>", self._on_alt_up),
                            ("<KeyRelease-Alt_R>", self._on_alt_up))
        ]
        self.protocol("WM_DELETE_WINDOW", self._close)

    def _is_active_dialog(self) -> bool:
        """Alt handlers are bound application-wide (Tk focus quirks); act
        only while focus is inside this dialog (reference
        gui_components.py:2043-2048)."""
        try:
            widget = self.focus_get()
        except (KeyError, tk.TclError):
            return False
        return widget is not None and widget.winfo_toplevel() is self

    def _unbind_alt(self):
        # Drop the application-wide Alt bindings this dialog installed (no
        # other widget in this app binds Alt on the 'all' bindtag) so closed
        # dialogs are not kept alive by stale handlers.
        for seq, funcid in self._alt_bind_ids:
            try:
                self.unbind_all(seq)
                self.deletecommand(funcid)
            except tk.TclError:
                pass
        self._alt_bind_ids = []

    # -- stages --

    def _clear(self):
        for child in list(self.toolbar.winfo_children()) + \
                list(self.body.winfo_children()):
            child.destroy()
        self.preview = None
        self.canvas = None

    def _show_preview(self, target_size: int):
        self._target_size = target_size
        self._clear()
        ttk.Label(self.toolbar, text="Target size:").pack(side="left")
        self.size_var = tk.StringVar(value=str(target_size))
        ent = ttk.Entry(self.toolbar, textvariable=self.size_var, width=5)
        ent.pack(side="left", padx=4)
        ttk.Button(self.toolbar, text="Convert",
                   command=self._convert).pack(side="right")
        ttk.Label(self.toolbar,
                  text="Alt+wheel: scale grid, Alt+drag: move grid"
                  ).pack(side="right", padx=8)
        self.preview = GridPreviewCanvas(
            self.body, self.source, target_size, width=640, height=480,
            **({"bg": self.canvas_bg} if self.canvas_bg else {}))
        self.preview.pack(fill="both", expand=True)
        self.size_var.trace_add(
            "write", lambda *_: self._sync_target_size())

    def _sync_target_size(self):
        try:
            n = int(self.size_var.get())
            if n > 0:
                self._target_size = n
                if self.preview:
                    self.preview.set_target_size(n)
        except ValueError:
            pass  # empty/partial entry while typing; keep last good size

    def _convert(self):
        if not self.preview:
            return
        tw, th, cw, ch = self.preview.grid_geometry()
        grid = sample_grid_with_geometry(
            self.source, (tw, th), (cw, ch), tuple(self.preview.grid_offset))
        self._show_editor(grid)

    def _show_editor(self, grid: np.ndarray):
        self._clear()
        self.canvas = PixelizationEditorCanvas(
            self.body, grid,
            cell_px=max(2, 512 // max(grid.shape[:2])),
            **({"bg": self.canvas_bg} if self.canvas_bg else {}))
        for label, tool in [("Brush", "brush"), ("Fill", "fill"), ("Pick", "picker")]:
            ttk.Button(self.toolbar, text=label,
                       command=lambda t=tool: self._set_tool(t)
                       ).pack(side="left", padx=2)
        ttk.Button(self.toolbar, text="Color...",
                   command=self._choose_color).pack(side="left", padx=6)
        ttk.Button(self.toolbar, text="Undo",
                   command=self.canvas.undo).pack(side="left")
        ttk.Button(self.toolbar, text="Redo",
                   command=self.canvas.redo).pack(side="left")
        ttk.Button(self.toolbar, text="Back",
                   command=lambda: self._show_preview(self._target_size)
                   ).pack(side="right", padx=4)
        ttk.Button(self.toolbar, text="Apply",
                   command=self._apply).pack(side="right")
        self.canvas.pack()

    def _set_tool(self, tool: str):
        if self.canvas:
            self.canvas.tool = tool

    # -- Alt-hold: temporary picker in edit mode, grid zoom in preview --

    def _on_alt_down(self, _e):
        if not self._is_active_dialog():
            return
        if self.preview:
            self.preview.alt_down = True
        if self.canvas and not self._alt_pick_active \
                and self.canvas.tool != "picker":
            self._alt_prev_tool = self.canvas.tool
            self._alt_pick_active = True
            self.canvas.tool = "picker"

    def _on_alt_up(self, _e):
        if self.preview:
            self.preview.alt_down = False
        if self._alt_pick_active:
            self._alt_pick_active = False
            self.canvas.tool = self._alt_prev_tool or "brush"
            self._alt_prev_tool = None

    # -- geometry persistence (reference gui_components.py:1814-1860) --

    def _load_geometry(self):
        if not self.config_mgr:
            self.geometry("760x560")
            return
        w = self.config_mgr.get("pixelization_editor", "dialog_width",
                                default=760)
        h = self.config_mgr.get("pixelization_editor", "dialog_height",
                                default=560)
        x = self.config_mgr.get("pixelization_editor", "dialog_x")
        y = self.config_mgr.get("pixelization_editor", "dialog_y")
        if x is not None and y is not None:
            self.geometry(f"{w}x{h}+{x}+{y}")
        else:
            self.geometry(f"{w}x{h}")

    def _save_geometry(self):
        if not self.config_mgr:
            return
        size_pos = self.geometry().split("+")
        size = size_pos[0].split("x")
        self.config_mgr.set("pixelization_editor", "dialog_width",
                            value=int(size[0]))
        self.config_mgr.set("pixelization_editor", "dialog_height",
                            value=int(size[1]))
        if len(size_pos) >= 3:
            self.config_mgr.set("pixelization_editor", "dialog_x",
                                value=int(size_pos[1]))
            self.config_mgr.set("pixelization_editor", "dialog_y",
                                value=int(size_pos[2]))

    def _choose_color(self):
        rgb, _hex = colorchooser.askcolor(rgb_to_hex(self.canvas.brush_color),
                                          parent=self)
        if rgb:
            self.canvas.brush_color = tuple(int(v) for v in rgb)

    def _close(self):
        self._save_geometry()
        self._unbind_alt()
        self.destroy()

    def _apply(self):
        if self.on_apply and self.canvas is not None:
            self.on_apply(Image.fromarray(self.canvas.grid_data))
        self._save_geometry()
        self._unbind_alt()
        self.destroy()
