"""Display-gated smoke test of the port's GUI, as ``tests/test_gui_smoke.py``
holds the JAX package's: build the real app (``DitheringApp(device="cpu")``),
push an image through pixelize -> dither, drive the pixelization editor
(preview grid -> convert -> edit -> apply) and the palette preview dialog.
Skipped where no display is available (no $DISPLAY and no Xvfb); it runs
on any workstation or CI with one."""

import os

import numpy as np
import pytest
from PIL import Image
import torch_workers  # noqa: F401


def _display_available():
    if os.environ.get("DISPLAY"):
        return True
    try:
        import tkinter

        root = tkinter.Tk()
        root.destroy()
        return True
    except Exception:
        return False


@pytest.fixture(autouse=True)
def display():
    if not _display_available():
        pytest.skip("no display (DISPLAY unset, no Xvfb)")


@pytest.fixture()
def source_image():
    y, x = np.mgrid[0:96, 0:128]
    arr = np.stack([x * 2 % 256, y * 2 % 256,
                    (x + y) % 256], -1).astype(np.uint8)
    return Image.fromarray(arr)


def test_app_pixelize_and_dither(source_image, tmp_path, monkeypatch):
    import tkinter as tk

    from dither_pie_tpu_torch.gui.app import DitheringApp

    monkeypatch.chdir(tmp_path)  # config.json writes land in tmp
    root = tk.Tk()
    root.withdraw()
    try:
        app = DitheringApp(root, device="cpu")
        assert str(app.vm.device) == "cpu"
        app.current_image = source_image
        app._show(source_image, "current", keep_view=False)
        app.pixelize_regular_action()
        root.update()
        assert app.pixelized_image is not None
        ph, pw = np.array(app.pixelized_image).shape[:2]
        assert ph % 2 == 0 and pw % 2 == 0

        # Dither via the same ditherer the dialog builds (no modal).
        d = app._build_ditherer(
            [(0, 0, 0), (255, 255, 255), (255, 0, 0), (0, 0, 255)], 4)
        assert str(d.device) == "cpu"
        out = d.apply_dithering(app.pixelized_image)
        app.dithered_image = out
        app._show(out, "dithered", keep_view=False)
        root.update()
        uniq = len(np.unique(np.array(out).reshape(-1, 3), axis=0))
        assert uniq <= 4
    finally:
        root.destroy()


def test_pixelization_editor_dialog_flow(source_image, tmp_path, monkeypatch):
    import tkinter as tk

    from dither_pie_tpu_torch.api.config_manager import ConfigManager
    from dither_pie_tpu_torch.gui.widgets import PixelizationEditorDialog

    monkeypatch.chdir(tmp_path)
    root = tk.Tk()
    root.withdraw()
    try:
        applied = []
        cfg = ConfigManager(str(tmp_path / "config.json"))
        dlg = PixelizationEditorDialog(root, source_image, target_size=16,
                                       on_apply=applied.append,
                                       config_mgr=cfg)
        root.update()
        assert dlg.preview is not None
        dlg.preview.grid_scale = 0.9
        dlg._convert()
        root.update()
        assert dlg.canvas is not None
        dlg.canvas.brush_color = (10, 20, 30)
        dlg.canvas.paint_cell(0, 0)
        dlg._apply()
        root.update()
        assert applied and np.array(applied[0])[0, 0].tolist() == [10, 20, 30]
        # geometry persisted
        assert cfg.get("pixelization_editor", "dialog_width") > 0
    finally:
        root.destroy()


def test_palette_preview_dialog(source_image, tmp_path):
    import tkinter as tk

    from dither_pie_tpu_torch.gui.widgets import PaletteImagePreviewDialog

    root = tk.Tk()
    root.withdraw()
    try:
        dlg = PaletteImagePreviewDialog(
            root, [(0, 0, 0), (255, 255, 255)], str(tmp_path / "x.png"), 2)
        root.update()
        dlg._use()
        assert dlg.use_result and not dlg.choose_another
    finally:
        root.destroy()
