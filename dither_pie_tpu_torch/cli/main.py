"""Dither Pie TPU, PyTorch/CUDA port — command-line interface.

JSON-config-driven batch processing of images, videos and folders, with the
JAX package's config schema, override semantics, smart output filenames and
exit codes (0, 1, and 130 on Ctrl+C; ``dither_pie_tpu/cli/main.py``),
running the port's pipelines on one device:

    python -m dither_pie_tpu_torch <config.json> [input] [--device cpu]
                                   [--shard I:N] [--resume]

``--device`` (``cuda``, the default, or ``cpu``) takes the place of the JAX
package's backend choice: it is resolved once (``api/runtime.py``), and
``cuda`` on a machine without a card is an error, never a fall-back to the
CPU. ``--shard INDEX:COUNT`` strides a video's segment grid or a folder's
file list across hosts that share a filesystem (``parallel/multihost.py``).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path
from typing import Any, Dict, Optional

import torch
from rich.console import Console

from dither_pie_tpu_torch.api.config import (
    ConfigValidationError,
    detect_mode,
    load_config,
    validate_config,
)
from dither_pie_tpu_torch.api.ditherer import DitherMode, PaletteSource, PixelizeMethod
from dither_pie_tpu_torch.api.runtime import DeviceLike, resolve_device
from dither_pie_tpu_torch.utils import IMAGE_EXTENSIONS, VIDEO_EXTENSIONS

__all__ = [
    "main",
    "setup_logging",
    "CLIProgressCallback",
    "ConfigValidationError",
    "validate_config",
    "load_config",
    "detect_mode",
    "process_single_image",
    "process_single_video",
    "process_folder",
    "generate_output_filename",
]

console = Console()
logger = logging.getLogger("dither_pie_tpu_torch")


def setup_logging(verbose: bool = False, quiet: bool = False,
                  log_file: Optional[str] = None):
    """Rich console logging when on a tty, plain otherwise; optional file."""
    level = logging.ERROR if quiet else (logging.DEBUG if verbose else logging.INFO)
    handlers = []
    if sys.stdout.isatty():
        from rich.logging import RichHandler

        handlers.append(RichHandler(console=console, show_time=True,
                                    show_path=False, markup=False,
                                    rich_tracebacks=True))
    else:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
        handlers.append(sh)
    if log_file:
        fh = logging.FileHandler(log_file, mode="a", encoding="utf-8")
        fh.setFormatter(logging.Formatter(
            "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
        handlers.append(fh)
    logging.basicConfig(level=level, format="%(message)s", datefmt="[%X]",
                        handlers=handlers, force=True)
    logger.setLevel(level)
    return logger


class CLIProgressCallback:
    """Context-manager progress bar compatible with the VideoProcessor
    callback protocol ``(fraction: float, message: str)``."""

    def __init__(self, total_frames: int = 100):
        self.total_frames = total_frames
        self.progress = None
        self.task = None
        self.use_rich = sys.stdout.isatty()

    def __enter__(self):
        if self.use_rich:
            from rich.progress import (BarColumn, Progress, SpinnerColumn,
                                       TaskProgressColumn, TextColumn)

            self.progress = Progress(
                SpinnerColumn(),
                TextColumn("[progress.description]{task.description}"),
                BarColumn(),
                TaskProgressColumn(),
                console=console,
            )
            self.progress.__enter__()
            self.task = self.progress.add_task("Processing video...", total=100)
        return self

    def __exit__(self, *args):
        if self.progress:
            self.progress.__exit__(*args)

    def update(self, fraction: float, message: str):
        if self.use_rich and self.progress and self.task is not None:
            self.progress.update(self.task, completed=fraction * 100,
                                 description=message)
        elif not self.use_rich:
            print(f"Progress: {int(fraction * 100)}% - {message}", flush=True)

    def finish(self):
        self.update(1.0, "Complete!")


# Re-exported pipeline entry points (the CLI surface mirrors the original
# application's module-level functions).
from dither_pie_tpu_torch.pipeline.image import process_single_image  # noqa: E402
from dither_pie_tpu_torch.pipeline.video import process_single_video  # noqa: E402


def generate_output_filename(input_path: Path, config: Dict[str, Any]) -> Path:
    """Smart output names: stem(<=30) + pix{N} + mode + palette tag + gamma."""
    base_stem = input_path.stem[:30]
    parts = [base_stem]

    if config["pixelization"]["enabled"]:
        if config["pixelization"]["method"] != PixelizeMethod.NONE.value:
            parts.append(f"pix{config['pixelization']['max_size']}")

    if config["dithering"]["enabled"]:
        parts.append(config["dithering"]["mode"])
        palette_source = config["palette"]["source"]
        num_colors = config["palette"]["num_colors"]
        if palette_source == PaletteSource.MEDIAN_CUT.value:
            parts.append(f"{num_colors}c")
        elif palette_source == PaletteSource.KMEANS.value:
            parts.append(f"km{num_colors}c")
        elif palette_source == PaletteSource.UNIFORM.value:
            parts.append(f"uni{num_colors}c")
        elif palette_source.startswith(f"{PaletteSource.FROM_FILE.value}:"):
            parts.append(f"{num_colors}c")
        else:
            palette_name = palette_source.replace("custom:", "")[:10]
            parts.append(palette_name)
        if config["palette"]["use_gamma"]:
            parts.append("gamma")

    return input_path.parent / f"{'_'.join(parts)}{input_path.suffix}"


def process_folder(config: Dict[str, Any], host_index: int = 0,
                   host_count: int = 1, device: DeviceLike = "cuda") -> bool:
    """Process every image/video in a folder on ``device``; continue-on-error
    + summary.

    ``host_index``/``host_count`` (CLI ``--shard``) stride the sorted file
    list across hosts — each host processes files where
    ``i % host_count == host_index`` (file-level data parallelism; no
    coordination needed beyond a shared output directory)."""
    try:
        input_path = Path(config["input"])
        output_path = Path(config["output"])
        if not input_path.is_dir():
            logger.error(f"Input path is not a directory: {input_path}")
            return False

        all_files = sorted(input_path.iterdir())
        image_files = [f for f in all_files
                       if f.is_file() and f.suffix.lower() in IMAGE_EXTENSIONS]
        video_files = [f for f in all_files
                       if f.is_file() and f.suffix.lower() in VIDEO_EXTENSIONS]
        if host_count > 1:
            media = image_files + video_files
            mine = set(str(f) for f in media[host_index::host_count])
            image_files = [f for f in image_files if str(f) in mine]
            video_files = [f for f in video_files if str(f) in mine]
            logger.info(f"Shard {host_index}/{host_count}: "
                        f"{len(mine)} of {len(media)} files")
        if not image_files and not video_files:
            if host_count > 1:
                logger.info("No files in this host's shard")
                return True
            logger.error(f"No processable image or video files found in: {input_path}")
            return False

        output_path.mkdir(parents=True, exist_ok=True)
        total = len(image_files) + len(video_files)
        logger.info(f"Found {len(image_files)} images and {len(video_files)} videos")
        logger.info(f"Output directory: {output_path}")

        # Pre-load the neural pixelizer once for the whole batch.
        if (config["pixelization"]["enabled"]
                and config["pixelization"]["method"] == PixelizeMethod.NEURAL.value):
            logger.info("Pre-loading neural pixelization models... (one-time setup)")
            try:
                from dither_pie_tpu_torch.pipeline.pixelize import get_neural_pixelizer

                get_neural_pixelizer(device=device)
                logger.info("Neural models loaded")
            except Exception as e:
                logger.error(f"Failed to load neural models: {e}")
                return False

        success_count, failed_files = 0, []

        def run_one(f: Path, mode: str, fn) -> None:
            nonlocal success_count
            file_config = dict(config)
            file_config["input"] = str(f)
            file_config["output"] = str(output_path / f.name)
            file_config["mode"] = mode
            logger.info(f"Processing: {f.name}")
            try:
                ok = fn(file_config, device=device)
            except KeyboardInterrupt:
                raise
            except Exception as e:
                logger.error(f"Error processing {f.name}: {e}")
                ok = False
            if ok:
                success_count += 1
            else:
                failed_files.append(f.name)

        try:
            for idx, f in enumerate(image_files, 1):
                logger.info(f"[{idx}/{len(image_files)}]")
                run_one(f, "image", process_single_image)
            for idx, f in enumerate(video_files, 1):
                logger.info(f"[{idx}/{len(video_files)}]")
                run_one(f, "video", process_single_video)
        except KeyboardInterrupt:
            logger.warning("Processing interrupted by user")

        logger.info("=" * 40)
        logger.info("Batch Processing Summary")
        logger.info("=" * 40)
        logger.info(f"Total files:     {total}")
        logger.info(f"Successful:      {success_count}")
        if failed_files:
            logger.info(f"Failed:          {len(failed_files)}")
            for name in failed_files:
                logger.info(f"  - {name}")
        return success_count > 0

    except Exception as e:
        logger.error(f"Failed to process folder: {e}", exc_info=True)
        return False


def show_help():
    console.print("""
[bold cyan]Dither Pie TPU, PyTorch/CUDA port — Usage[/]

[bold]Basic Usage:[/]
  python -m dither_pie_tpu_torch <config.json>                Process with JSON config
  python -m dither_pie_tpu_torch <config.json> <file/folder>  Process file/folder with config settings
  python -m dither_pie_tpu_torch --help                       Show this help
  python -m dither_pie_tpu_torch --example-config             Generate example config

[bold]Options:[/]
  --verbose, -v       Enable verbose output
  --quiet, -q         Suppress all but error messages
  --log-file FILE     Write log to file
  --device DEVICE     cuda (default) or cpu
  --resume            Segmented video processing with checkpoint/resume
  --shard INDEX:COUNT This host's strided share of a video's segments or a folder's files

[bold]Available Dither Modes:[/]""")
    for mode in DitherMode:
        console.print(f"    • [cyan]{mode.value}[/]")
    console.print("")


def generate_example_config():
    example = {
        "_comment": "Dither Pie TPU Configuration "
                    "(run: python -m dither_pie_tpu_torch config.json)",
        "input": "path/to/input.png",
        "output": "path/to/output.png",
        "mode": "image",
        "pixelization": {"enabled": True,
                         "method": PixelizeMethod.REGULAR.value,
                         "max_size": 128},
        "dithering": {"enabled": True, "mode": "bayer", "parameters": {}},
        "palette": {
            "_comment_source": "Options: median_cut, kmeans, uniform, "
                               "file:path.png, custom:palette_name, or direct palette name",
            "source": PaletteSource.MEDIAN_CUT.value,
            "_comment_num_colors": "Ignored for custom/predefined palettes "
                                   "(uses palette's actual color count)",
            "num_colors": 16,
            "use_gamma": False,
        },
        "final_resize": {"enabled": False, "multiplier": 2},
    }
    print(json.dumps(example, indent=4))


def _device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"cuda ({torch.cuda.get_device_name(dev)})"
    return dev.type


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Dither Pie TPU, PyTorch/CUDA port — Image & Video Dithering",
        add_help=False)
    parser.add_argument("config", nargs="?")
    parser.add_argument("input_override", nargs="?")
    parser.add_argument("--help", "-h", action="store_true")
    parser.add_argument("--example-config", action="store_true")
    parser.add_argument("--verbose", "-v", action="store_true")
    parser.add_argument("--quiet", "-q", action="store_true")
    parser.add_argument("--log-file", type=str)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="device the pipelines run on (default cuda; a "
                             "machine without a card is an error)")
    parser.add_argument("--resume", action="store_true",
                        help="segmented video processing with checkpoint/resume")
    parser.add_argument("--shard", type=str, default=None, metavar="INDEX:COUNT",
                        help="multi-host sharding: this host processes its "
                             "strided share of the segment grid or the folder's "
                             "files (e.g. 0:4)")
    args = parser.parse_args(argv)

    if args.help:
        show_help()
        return 0
    if args.example_config:
        generate_example_config()
        return 0

    setup_logging(verbose=args.verbose, quiet=args.quiet, log_file=args.log_file)

    # Resolve the device once; CUDA without a card is an error.
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        logger.error(str(e))
        return 1
    logger.info(f"Compute device: {_device_name(device)}")

    if not args.config:
        console.print("[bold red]Error:[/] No configuration file specified.\n")
        console.print("Usage: python -m dither_pie_tpu_torch <config.json>")
        console.print("       python -m dither_pie_tpu_torch --help\n")
        return 1

    config_path = Path(args.config)
    if not config_path.exists():
        logger.error(f"Configuration file not found: {config_path}")
        return 1

    logger.info(f"Loading configuration from: {config_path}")
    try:
        config = load_config(config_path, skip_input_check=bool(args.input_override))
    except ConfigValidationError as e:
        logger.error(str(e))
        return 1
    except Exception as e:
        logger.error(f"Unexpected error loading config: {e}")
        return 1
    logger.info("Configuration validated")

    if args.input_override:
        override = Path(args.input_override)
        if not override.exists():
            logger.error(f"Input override file/folder not found: {override}")
            return 1
        config["input"] = str(override.resolve())
        if override.is_dir():
            config["output"] = str((override.parent / f"{override.name}_processed").resolve())
            config["mode"] = "folder"
        else:
            config["output"] = str(generate_output_filename(override, config).resolve())
            config["mode"] = None
        logger.info(f"Using input override: {override.name}")
        logger.info(f"Generated output: {Path(config['output']).name}")

    if not config["mode"]:
        try:
            config["mode"] = detect_mode(Path(config["input"]))
            logger.info(f"Auto-detected mode: {config['mode']}")
        except ConfigValidationError as e:
            logger.error(str(e))
            return 1

    hi, hc = 0, 1
    if args.shard:
        from dither_pie_tpu_torch.parallel.multihost import parse_shard

        try:
            hi, hc = parse_shard(args.shard)
        except ValueError as e:
            logger.error(str(e))
            return 1
        if config["mode"] == "image":
            logger.warning("--shard applies to video/folder modes; ignored")

    logger.info(f"Input:  {config['input']}")
    logger.info(f"Output: {config['output']}")
    logger.info(f"Mode:   {config['mode']}")

    try:
        if config["mode"] == "image":
            success = process_single_image(config, device=device)
        elif config["mode"] == "video":
            success = process_single_video(config, resume=args.resume,
                                           host_index=hi, host_count=hc, device=device)
        else:
            success = process_folder(config, host_index=hi, host_count=hc, device=device)
    except KeyboardInterrupt:
        logger.warning("Processing interrupted by user (Ctrl+C)")
        return 130

    if success:
        logger.info("Processing complete!")
        return 0
    logger.error("Processing failed!")
    return 1


if __name__ == "__main__":
    sys.exit(main())
