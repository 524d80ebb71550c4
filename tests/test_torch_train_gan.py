"""The port's trainer command line (dither_pie_tpu_torch.tools.train_gan) on
the CPU: two epochs and a resume to the third equal to three epochs
uninterrupted, bitwise, under the step schedule (cut at epoch 2, so the
resumed epoch runs at another lr) and the plateau schedule (whose
side-state rides in the checkpoint); the linear and cosine schedules
depend on --epochs, so a run of 2 epochs is not the start of a run of 3
under them; the error exits; the card by default;
several devices data-parallel with the batch rounded up. 4 pairs of 40x40 images, --size 32,
dim 8 / conv-dim 8, batch 2."""

import numpy as np
import pytest
import torch
from PIL import Image

from dither_pie_tpu_torch.models import training as tt
from dither_pie_tpu_torch.tools.train_gan import _load_image, main
import torch_workers  # noqa: F401


@pytest.fixture()
def pairs(tmp_path):
    src_d, real_d = tmp_path / "src", tmp_path / "real"
    src_d.mkdir(), real_d.mkdir()
    rng = np.random.RandomState(0)
    for i in range(4):
        for d in (src_d, real_d):
            Image.fromarray(rng.randint(0, 256, (40, 40, 3), dtype=np.uint8)).save(d / f"{i}.png")
    return src_d, real_d


def common(src_d, real_d, ck, *extra):
    return ["--src", str(src_d), "--real", str(real_d), "--batch", "2", "--size", "32",
            "--dim", "8", "--conv-dim", "8", "--ckpt", str(ck), "--device", "cpu", *extra]


def ckpt_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("policy", ["step", "plateau"])
def test_resume_equals_uninterrupted(pairs, tmp_path, policy):
    src_d, real_d = pairs
    ck, ck3 = tmp_path / "ck.npz", tmp_path / "straight"
    sched = ["--lr-policy", policy, "--decay-epochs", "2"]
    assert main(["--epochs", "2", "--save-every", "1"] + sched
                + common(src_d, real_d, ck)) == 0
    assert int(ckpt_arrays(ck)["__step__"]) == 2
    assert main(["--epochs", "3"] + sched + common(src_d, real_d, ck)) == 0
    assert main(["--epochs", "3"] + sched + common(src_d, real_d, ck3)) == 0
    resumed, straight = ckpt_arrays(ck), ckpt_arrays(str(ck3) + ".npz")
    assert int(resumed["__step__"]) == 3
    assert resumed.keys() == straight.keys()
    assert all(np.array_equal(resumed[k], straight[k]) for k in resumed)
    assert any(k.startswith("extra_") for k in resumed) == (policy == "plateau")
    like = tt.gan_init(dim=8, conv_dim=8, device="cpu")
    _, step, _ = tt.load_train_state(str(ck), like)
    assert step == 3


def test_error_exits(pairs, tmp_path, capsys):
    src_d, real_d = pairs
    ck = tmp_path / "ck.npz"
    assert main(["--epochs", "1"] + common(src_d, real_d, ck) + ["--size", "30"]) == 1
    assert "multiple of 4" in capsys.readouterr().err
    empty = tmp_path / "empty"
    empty.mkdir()
    assert main(["--epochs", "1"] + common(src_d, empty, ck)) == 1
    assert "no filename-matched pairs" in capsys.readouterr().err
    assert main(["--epochs", "1"] + common(src_d, real_d, ck) + ["--batch", "5"]) == 1
    assert "exceeds dataset size" in capsys.readouterr().err
    assert not ck.exists()


def test_card_by_default(pairs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for machines without")
    src_d, real_d = pairs
    args = [a for a in common(src_d, real_d, tmp_path / "ck") if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--epochs", "1"] + args)


def test_several_cards_are_a11(pairs, tmp_path, monkeypatch, capsys):
    """Several local devices (two CPU positions through the mesh's seam,
    ``parallel.auto.local_devices``): the step is data-parallel, the batch
    rounded up to a multiple of the devices, with the JAX trainer's two
    lines; --no-mesh trains on one device at the batch asked for."""
    from dither_pie_tpu_torch.parallel import auto

    src_d, real_d = pairs
    monkeypatch.setattr(auto, "local_devices", lambda device: [torch.device("cpu")] * 2)
    args = common(src_d, real_d, tmp_path / "ck")
    args[args.index("--batch") + 1] = "3"
    assert main(["--epochs", "1"] + args) == 0
    out = capsys.readouterr().out
    assert "batch rounded up to 4 (multiple of 2 devices)\ndata-parallel over 2 devices\n" in out
    assert "1 steps)" in out  # 4 pairs at batch 4
    args[args.index("--ckpt") + 1] = str(tmp_path / "ck1")
    assert main(["--epochs", "1", "--no-mesh"] + args) == 0
    out = capsys.readouterr().out
    assert "data-parallel" not in out and "1 steps)" in out


def test_load_image_crops_and_scales(tmp_path):
    arr = np.zeros((30, 50, 3), np.uint8)
    arr[:, 25:] = 255
    Image.fromarray(arr).save(tmp_path / "a.png")
    img = _load_image(str(tmp_path / "a.png"), 12)
    assert img.shape == (12, 12, 3) and img.dtype == np.float32
    assert img.min() >= -1.0 and img.max() <= 1.0
    assert img[:, 0].max() < -0.9 and img[:, -1].min() > 0.9
