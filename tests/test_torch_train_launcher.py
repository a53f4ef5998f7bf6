"""The port's training launcher (`repro_torch.launch.train`) on the CPU:
the reference launcher's cases (`tests/test_launchers.py`), a resume
held bitwise to the uninterrupted run, and training checkpoints crossing
between the packages in both directions.

Tolerance: a resume in the other package continues from the same
bfloat16 parameters and float32 moments, but each package rounds its
bfloat16 products its own way; its three losses are held within
`CROSS_RTOL`, one bfloat16 rounding step (2⁻⁸ relative), of the
writer's own resume (the gaps measured 5e-6 to 1.7e-4).  Everything
else here is bitwise.
"""
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import train as r_train  # noqa: E402
from repro_torch.checkpoint.checkpointer import (  # noqa: E402
    MANIFEST, Checkpointer)
from repro_torch.launch import train as t_train  # noqa: E402

CROSS_RTOL = 2.0 ** -8
SMALL = ["--batch", "2", "--seq", "32", "--ckpt-every", "3"]


def raw(leaf):
    """A loaded leaf's bytes (bfloat16 leaves load as CPU tensors)."""
    if torch.is_tensor(leaf):
        return leaf.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(leaf).tobytes()


def port_main(args):
    return t_train.main(args + ["--device", "cpu"])


def test_launcher_loss_decreases(tmp_path):
    """`tests/test_launchers.py`'s training case, through the port."""
    losses = port_main([
        "--arch", "qwen3-1.7b", "--steps", "12", "--batch", "4",
        "--seq", "64", "--lr", "3e-3", "--ckpt-dir", str(tmp_path),
        "--ckpt-every", "6"])
    assert len(losses) == 12
    assert losses[-1] < losses[0]          # synthetic zipf is learnable
    assert all(np.isfinite(losses))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m",
                                  "mamba2-2.7b"])
def test_launcher_resume_is_bitwise(tmp_path, arch):
    """6 steps, then `--resume` to 9: exactly steps 7–9 of an
    uninterrupted 9-step run, and the same final state."""
    args = ["--arch", arch, "--steps", "9"] + SMALL
    full = port_main(args + ["--ckpt-dir", str(tmp_path / "full")])
    cut = str(tmp_path / "cut")
    first = port_main(["--arch", arch, "--steps", "6", "--ckpt-dir", cut]
                      + SMALL)
    assert first == full[:6]
    resumed = port_main(args + ["--ckpt-dir", cut, "--resume"])
    assert len(resumed) == 3
    assert resumed == full[6:]
    a, meta_a = Checkpointer(str(tmp_path / "full")).load(9)
    b, meta_b = Checkpointer(cut).load(9)
    assert meta_a["treedef"] == meta_b["treedef"]
    for x, y in zip(a, b):
        assert raw(x) == raw(y)


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_training_checkpoint_crosses_packages(tmp_path, writer):
    """One package trains 6 steps; each package resumes that checkpoint
    to step 9.  The other package's losses are within CROSS_RTOL of the
    writer's own resume, and both write the same checkpoint layout."""
    args = ["--arch", "qwen3-1.7b"] + SMALL
    mine, other = tmp_path / "mine", tmp_path / "other"
    write = r_train.main if writer == "repro" else port_main
    read = port_main if writer == "repro" else r_train.main
    write(args + ["--steps", "6", "--ckpt-dir", str(mine)])
    shutil.copytree(mine, other)
    own = write(args + ["--steps", "9", "--resume", "--ckpt-dir",
                        str(mine)])
    crossed = read(args + ["--steps", "9", "--resume", "--ckpt-dir",
                           str(other)])
    assert len(own) == len(crossed) == 3
    assert np.all(np.isfinite(crossed))
    np.testing.assert_allclose(crossed, own, rtol=CROSS_RTOL)
    manifests = []
    for d in (mine, other):
        with open(d / "step_00000009" / MANIFEST) as f:
            manifests.append(json.load(f))
    for key in ("treedef", "n_leaves", "shapes", "dtypes"):
        assert manifests[0][key] == manifests[1][key], key
    assert "CustomNode(namedtuple[AdamWState]" in manifests[0]["treedef"]


def test_launcher_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="is_available"):
        t_train.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])


def test_launcher_raises_for_unported_families(tmp_path):
    """The launcher feeds tokens only: the encoder-decoder, whose loss
    needs frames, is refused before anything is built (the reference's
    launcher feeds it no frames either)."""
    with pytest.raises(ValueError, match="frames"):
        port_main(["--arch", "whisper-small", "--steps", "1",
                   "--ckpt-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())
