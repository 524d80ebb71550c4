"""Train P2CGen against CPDis (supervised GAN translation) on the card.

    python -m dither_pie_tpu_torch.tools.train_gan --src pixel_dir --real clip_dir
        [--epochs N] [--batch B] [--size 256] [--lr 2e-4]
        [--lr-policy linear|step|cosine|plateau] [--gan-mode lsgan]
        [--ckpt ckpt.npz] [--save-every E] [--device cuda] [--no-mesh]

The JAX package's trainer (``dither_pie_tpu/tools/train_gan.py``) with its
flags, on ``models/training.py``:

* pairs are matched by filename between --src and --real; each image is
  resized (bicubic) so its short side is --size, centre-cropped to a
  square and scaled to [-1, 1];
* the train step runs in float32 with TF32 off and cuDNN's deterministic
  algorithms, on the card (``--device cuda``, the default; a machine
  without one raises) or on the CPU (``--device cpu``); with more than one
  visible card the step is data-parallel over all of them
  (``make_gan_train_step(mesh=)``, the batch rounded up to a multiple of
  the cards), unless --no-mesh asks for one card;
* --ckpt resumes from / saves the whole state (parameters, the spectral
  norm's u/v, Adam's moments, the plateau scheduler's side-state), every
  --save-every epochs and at the end, so an interrupted run continues
  exactly.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time


def _load_pairs(src_dir: str, real_dir: str):
    exts = ("*.png", "*.jpg", "*.jpeg", "*.webp")
    srcs = sorted(p for e in exts for p in glob.glob(os.path.join(src_dir, e)))
    pairs = []
    for s in srcs:
        r = os.path.join(real_dir, os.path.basename(s))
        if os.path.isfile(r):
            pairs.append((s, r))
    return pairs


def _load_image(path: str, size: int):
    """(size, size, 3) float32 in [-1, 1]."""
    import numpy as np
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    scale = size / min(w, h)
    img = img.resize((max(size, round(w * scale)), max(size, round(h * scale))),
                     Image.BICUBIC)
    w, h = img.size
    left, top = (w - size) // 2, (h - size) // 2
    img = img.crop((left, top, left + size, top + size))
    return np.asarray(img, dtype=np.float32) / 127.5 - 1.0


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train P2CGen vs CPDis (supervised GAN translation)")
    ap.add_argument("--src", required=True, help="source-domain image dir")
    ap.add_argument("--real", required=True,
                    help="target-domain dir (filenames matched to --src)")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=256, help="square crop size (multiple of 4)")
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--lr-policy", default="linear",
                    choices=("linear", "step", "cosine", "plateau"))
    ap.add_argument("--decay-epochs", type=int, default=None,
                    help="linear: epochs of decay at the end (default epochs/2); step: the "
                         "hold length before each 10x cut")
    ap.add_argument("--gan-mode", default="lsgan", choices=("lsgan", "vanilla", "wgangp"))
    ap.add_argument("--lambda-l1", type=float, default=100.0)
    ap.add_argument("--dim", type=int, default=64, help="generator width")
    ap.add_argument("--conv-dim", type=int, default=64, help="discriminator width")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", help="checkpoint .npz to resume from / save to")
    ap.add_argument("--save-every", type=int, default=5,
                    help="save checkpoint every N epochs (needs --ckpt)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--no-mesh", action="store_true",
                    help="train on one card where several are visible")
    args = ap.parse_args(argv)

    if args.size % 4:
        print("--size must be a multiple of 4", file=sys.stderr)
        return 1
    pairs = _load_pairs(args.src, args.real)
    if not pairs:
        print(f"no filename-matched pairs between {args.src} and {args.real}",
              file=sys.stderr)
        return 1
    print(f"{len(pairs)} training pairs")

    import numpy as np
    import torch

    from dither_pie_tpu_torch.api.runtime import resolve_device
    from dither_pie_tpu_torch.models.training import (
        ReduceLROnPlateau,
        checkpoint_path,
        gan_init,
        load_train_state,
        lr_schedule,
        make_gan_train_step,
        save_train_state,
        shard_batch,
    )
    from dither_pie_tpu_torch.parallel.auto import local_devices
    from dither_pie_tpu_torch.parallel.mesh import make_mesh

    dev = resolve_device(args.device)
    devices = local_devices(dev)
    mesh = None
    batch = args.batch
    if len(devices) > 1 and not args.no_mesh:
        mesh = make_mesh((len(devices),), ("data",), devices)
        dev = devices[0]  # the state lives on the mesh's first device
        if batch % len(devices):
            batch = -(-batch // len(devices)) * len(devices)
            print(f"batch rounded up to {batch} (multiple of {len(devices)} devices)")
        print(f"data-parallel over {len(devices)} devices")
    state = gan_init(lr=args.lr, dim=args.dim, conv_dim=args.conv_dim, seed=args.seed,
                     device=dev)
    start_epoch = 0
    ck_extra = {}
    if args.ckpt:
        args.ckpt = checkpoint_path(args.ckpt)
    if args.ckpt and os.path.isfile(args.ckpt):
        state, start_epoch, ck_extra = load_train_state(args.ckpt, state)
        print(f"resumed {args.ckpt} at epoch {start_epoch}")

    step = make_gan_train_step(gan_mode=args.gan_mode, lambda_l1=args.lambda_l1, mesh=mesh)

    decay = args.decay_epochs if args.decay_epochs is not None else args.epochs // 2
    plateau = lr_of = None
    if args.lr_policy == "plateau":
        plateau = ReduceLROnPlateau(args.lr)
        # The scheduler's side-state resumes with the run.
        if ck_extra:
            plateau.lr = ck_extra.get("plateau_lr", plateau.lr)
            plateau.best = ck_extra.get("plateau_best", plateau.best)
            plateau.num_bad_epochs = int(ck_extra.get("plateau_bad", plateau.num_bad_epochs))
    elif args.lr_policy == "linear":
        # Hold the base lr for the first (epochs - decay) epochs, then decay
        # linearly to ~0 over the last `decay`.
        lr_of = lr_schedule("linear", args.lr, epoch_count=1,
                            n_epochs=args.epochs - decay, n_epochs_decay=decay)
    elif args.lr_policy == "step":
        lr_of = lr_schedule("step", args.lr, lr_decay_iters=max(1, decay))
    else:  # cosine: one half-period over the whole run
        lr_of = lr_schedule("cosine", args.lr, n_epochs=args.epochs)

    def sched_extra():
        return ({"plateau_lr": plateau.lr, "plateau_best": plateau.best,
                 "plateau_bad": plateau.num_bad_epochs} if plateau else None)

    def batch_tensor(paths):
        arr = np.stack([_load_image(p, args.size) for p in paths])
        nchw = torch.from_numpy(arr).permute(0, 3, 1, 2).contiguous()
        return nchw.to(dev) if mesh is None else shard_batch(mesh, nchw)

    rng = np.random.RandomState(args.seed)
    order = np.arange(len(pairs))
    # Replay the shuffles of the epochs a resumed run skips, so that it
    # sees the uninterrupted run's batches.
    for _ in range(start_epoch):
        rng.shuffle(order)
    for epoch in range(start_epoch, args.epochs):
        lr = plateau.lr if plateau else lr_of(epoch)
        state.set_lr(lr)
        rng.shuffle(order)
        t0 = time.time()
        epoch_g = epoch_d = 0.0
        n_steps = 0
        for i in range(0, len(order) - batch + 1, batch):
            idx = order[i:i + batch]
            src = batch_tensor([pairs[j][0] for j in idx])
            real = batch_tensor([pairs[j][1] for j in idx])
            metrics = step(state, src, real)
            epoch_g += float(metrics["g_loss"])
            epoch_d += float(metrics["d_loss"])
            n_steps += 1
        if not n_steps:
            print(f"batch {batch} exceeds dataset size {len(pairs)}", file=sys.stderr)
            return 1
        g_avg, d_avg = epoch_g / n_steps, epoch_d / n_steps
        if plateau:
            plateau.step(g_avg)
        print(f"epoch {epoch + 1}/{args.epochs}  lr {lr:.2e}  G {g_avg:.4f}  D {d_avg:.4f}  "
              f"({time.time() - t0:.1f}s, {n_steps} steps)")
        if args.ckpt and (epoch + 1) % args.save_every == 0:
            save_train_state(args.ckpt, state, step=epoch + 1, extra=sched_extra())
            print(f"saved {args.ckpt}")
    if args.ckpt:
        save_train_state(args.ckpt, state, step=max(start_epoch, args.epochs),
                         extra=sched_extra())
        print(f"saved {args.ckpt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
