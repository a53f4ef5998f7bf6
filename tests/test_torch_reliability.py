"""Parity of the port's checkpointing and failure handling
(`repro_torch.checkpoint.checkpointer`, `repro_torch.runtime.fault`) with
`repro`'s, on `tests/test_reliability.py`'s cases, plus the on-disk
format shared by both packages: a checkpoint written by either loads in
the other with the same bytes, dtypes and manifest fingerprint."""
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import checkpointer as r_ckpt  # noqa: E402
from repro.runtime import fault as r_fault  # noqa: E402
from repro_torch.checkpoint import checkpointer as t_ckpt  # noqa: E402
from repro_torch.checkpoint.checkpointer import (  # noqa: E402
    LEAVES, MANIFEST, Checkpointer, ChecksumError, manifest_fingerprint,
    tree_flatten)
from repro_torch.runtime.fault import (Backoff, NodeFailure,  # noqa: E402
                                       StragglerPolicy, Supervisor)


class TestCheckpointer:
    def test_save_restore_roundtrip(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), keep=2)
        state = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 4))}}
        ckpt.save(5, state, blocking=True)
        restored, step = ckpt.restore(state, device="cpu")
        assert step == 5
        assert torch.equal(restored["a"], torch.arange(10.0))
        assert torch.equal(restored["b"]["c"], torch.ones((3, 4)))
        assert restored["a"].device.type == "cpu"

    def test_async_and_gc(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), keep=2)
        state = {"x": torch.zeros(100)}
        for s in (1, 2, 3, 4):
            ckpt.save(s, {"x": torch.full((100,), float(s))})
        ckpt.wait()
        assert ckpt.all_steps() == [3, 4]
        restored, step = ckpt.restore(state, device="cpu")
        assert step == 4 and float(restored["x"][0]) == 4.0

    def test_save_snapshots_cpu_leaves_before_returning(self, tmp_path,
                                                        monkeypatch):
        """An async save holds the values at the call, though the caller
        updates its CPU tensors in place right after (as the training
        step does); the write is held back until then."""
        release = threading.Event()
        savez = np.savez

        def held_savez(*args, **kwargs):
            release.wait(timeout=30)
            return savez(*args, **kwargs)

        monkeypatch.setattr(t_ckpt.np, "savez", held_savez)
        ckpt = Checkpointer(str(tmp_path))
        w = torch.arange(6.0).reshape(2, 3)
        state = {"w": w, "wt": w.t(), "b": w.to(torch.bfloat16),
                 "n": np.ones(3)}
        ckpt.save(1, state)
        for leaf in (w, state["b"], state["n"]):
            leaf += 1
        release.set()
        ckpt.wait()
        restored, _ = ckpt.restore(state, device="cpu")
        want = torch.arange(6.0).reshape(2, 3)
        assert torch.equal(restored["w"], want)
        assert torch.equal(restored["wt"], want.t())
        assert torch.equal(restored["b"], want.to(torch.bfloat16))
        assert torch.equal(restored["n"], torch.ones(3, dtype=torch.float64))

    def test_restore_keeps_scalar_leaves_scalar(self, tmp_path):
        """A 0-d leaf (the optimizer's step) restores with shape (), as
        `repro`'s `device_put` of the stored array does."""
        ckpt = Checkpointer(str(tmp_path))
        state = {"step": torch.tensor(6, dtype=torch.int32),
                 "x": torch.tensor(1.5)}
        ckpt.save(6, state, blocking=True)
        restored, _ = ckpt.restore(state, device="cpu")
        assert restored["step"].shape == () and int(restored["step"]) == 6
        assert restored["step"].dtype == torch.int32
        assert restored["x"].shape == () and float(restored["x"]) == 1.5
        r_restored, _ = r_ckpt.Checkpointer(str(tmp_path)).restore(
            {"step": jnp.zeros((), jnp.int32), "x": jnp.zeros(())})
        assert r_restored["step"].shape == restored["step"].shape

    def test_uncommitted_checkpoint_ignored(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path))
        ckpt.save(1, {"x": torch.ones(3)}, blocking=True)
        # a crash mid-save at step 2: a directory without COMMIT
        os.makedirs(tmp_path / "step_00000002")
        assert ckpt.latest_step() == 1

    def test_restore_detects_structure_mismatch(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path))
        ckpt.save(1, {"x": torch.ones(3)}, blocking=True)
        with pytest.raises(ValueError):
            ckpt.restore({"x": torch.ones(3), "y": torch.ones(2)},
                         device="cpu")

    def test_load_returns_host_leaves_and_meta(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path))
        ckpt.save(3, {"a": torch.arange(4.0), "b": torch.ones(2)},
                  blocking=True)
        leaves, meta = ckpt.load()
        assert meta["step"] == 3 and len(leaves) == 2
        assert all(isinstance(x, np.ndarray) for x in leaves)
        np.testing.assert_array_equal(leaves[0], np.arange(4.0))

    def test_torn_payload_raises_checksum_error(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path))
        ckpt.save(1, {"x": torch.arange(8.0)}, blocking=True)
        payload = tmp_path / "step_00000001" / LEAVES
        raw = bytearray(payload.read_bytes())
        raw[-1] ^= 0xFF                       # flip a byte: torn write
        payload.write_bytes(bytes(raw))
        with pytest.raises(ChecksumError):
            ckpt.load(step=1)
        with pytest.raises(ChecksumError):
            ckpt.restore({"x": torch.arange(8.0)}, step=1, device="cpu")
        leaves, _ = ckpt.load(step=1, verify=False)
        assert len(leaves) == 1

    def test_no_tmp_dirs_left_after_save(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path))
        ckpt.save(1, {"x": torch.ones(3)}, blocking=True)
        names = os.listdir(tmp_path)
        assert not [n for n in names if n.endswith(".tmp")]
        assert "step_00000001" in names

    def test_fingerprints_time_independent(self, tmp_path, monkeypatch):
        """Two saves of identical state at different wall clocks are
        identical in every fingerprint-covered byte."""
        state = {"a": torch.arange(10.0), "b": torch.ones((3, 4))}
        metas, payloads = [], []
        for i, fake_now in enumerate((1_000_000.0, 2_000_000.0)):
            monkeypatch.setattr(t_ckpt.time, "time", lambda t=fake_now: t)
            d = tmp_path / f"run{i}"
            Checkpointer(str(d)).save(5, state, blocking=True)
            step_dir = d / "step_00000005"
            payloads.append((step_dir / LEAVES).read_bytes())
            metas.append(json.loads((step_dir / MANIFEST).read_text()))
        assert metas[0]["time"] != metas[1]["time"]
        assert payloads[0] == payloads[1]
        assert metas[0]["sha256"] == metas[1]["sha256"]
        assert manifest_fingerprint(metas[0]) == manifest_fingerprint(metas[1])
        bumped = dict(metas[0], time=123.0)
        assert manifest_fingerprint(bumped) == manifest_fingerprint(metas[0])
        assert (manifest_fingerprint(dict(metas[0], step=6))
                != manifest_fingerprint(metas[0]))

    def test_restore_places_on_the_named_device_and_target_dtype(
            self, tmp_path):
        ckpt = Checkpointer(str(tmp_path))
        ckpt.save(2, [np.arange(3, dtype=np.int64), torch.ones(2)],
                  blocking=True)
        out, _ = ckpt.restore([torch.zeros(3, dtype=torch.int32),
                               np.zeros(2, np.float64)], device="cpu")
        assert out[0].dtype == torch.int32 and out[1].dtype == torch.float64
        assert out[0].tolist() == [0, 1, 2]

    def test_restore_defaults_to_the_card(self, tmp_path):
        """F6: with neither `shardings` nor `device`, every leaf goes to
        the card, as `repro`'s ``jax.device_put`` puts it on the default
        device; without a card that raises."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        ckpt = Checkpointer(str(tmp_path))
        ckpt.save(1, {"x": torch.ones(3)}, blocking=True)
        with pytest.raises(RuntimeError, match=r"requested but "
                           r"torch.cuda.is_available\(\) is False"):
            ckpt.restore({"x": torch.ones(3)})

    def test_restore_places_each_leaf_by_shardings(self, tmp_path):
        """`shardings`, a pytree of devices matching the target, places
        each leaf on its own device (the meta device stands in for a
        second one here), with `repro`'s values and dtypes."""
        state = {"a": np.arange(4, dtype=np.float32),
                 "b": (np.arange(3, dtype=np.int32),
                       np.full(2, 0.5, np.float32))}
        r_ckpt.Checkpointer(str(tmp_path)).save(3, state, blocking=True)
        ckpt = Checkpointer(str(tmp_path))
        target = {"a": torch.zeros(4), "b": (torch.zeros(3, dtype=torch.int32),
                                             torch.zeros(2))}
        out, step = ckpt.restore(target, shardings={
            "a": "meta", "b": (torch.device("cpu"), "cpu")})
        assert step == 3
        assert out["a"].device.type == "meta" and out["a"].shape == (4,)
        assert [x.device.type for x in out["b"]] == ["cpu", "cpu"]
        cpu = jax.devices("cpu")[0]
        want, _ = r_ckpt.Checkpointer(str(tmp_path)).restore(
            {"a": jnp.zeros(4), "b": (jnp.zeros(3, jnp.int32),
                                      jnp.zeros(2))},
            shardings={"a": cpu, "b": (cpu, cpu)})
        for got, ref in zip(out["b"], want["b"]):
            assert got.numpy().dtype == np.asarray(ref).dtype
            assert got.numpy().tobytes() == np.asarray(ref).tobytes()
        with pytest.raises(ValueError):
            ckpt.restore(target, shardings={"a": "cpu", "b": ("cpu",)})
        with pytest.raises(ValueError):
            r_ckpt.Checkpointer(str(tmp_path)).restore(
                {"a": jnp.zeros(4), "b": (jnp.zeros(3), jnp.zeros(2))},
                shardings={"a": cpu, "b": (cpu,)})
        with pytest.raises(ValueError, match="not both"):
            ckpt.restore(target, shardings={"a": "cpu", "b": ("cpu", "cpu")},
                         device="cpu")


# ---------------------------------------------------------------------------
# the pytree flatten and the shared on-disk format
# ---------------------------------------------------------------------------

def slab_np():
    """A slab dict of every dtype the sweeps and models write, as numpy."""
    rng = np.random.default_rng(0)
    return {"f32": rng.random((3, 4), dtype=np.float32),
            "i32": rng.integers(-9, 9, (2, 5)).astype(np.int32),
            "i64": rng.integers(-2 ** 40, 2 ** 40, 6),
            "flag": rng.random(7) < 0.5,
            "bf16": rng.standard_normal((4, 3)).astype(np.float32)}


def as_repro(slab):
    """The slab as `repro` holds it: host arrays, bf16 through jnp."""
    out = dict(slab)
    out["bf16"] = np.asarray(jnp.asarray(slab["bf16"]).astype(jnp.bfloat16))
    return out


def as_port(slab):
    out = {k: torch.from_numpy(v.copy()) for k, v in slab.items()}
    out["bf16"] = out["bf16"].to(torch.bfloat16)
    return out


def bf16_bits(x):
    """The raw 16-bit patterns of a bf16 leaf from either package."""
    if torch.is_tensor(x):
        return x.view(torch.int16).numpy()
    return x.view(np.int16)


@pytest.mark.parametrize("tree", [
    {"b": 1, "a": {"d": [2, 3], "c": (4,)}},
    [None, (1, 2), {"z": 3, "__q": 4}],
    (1,),
    torch.ones(2),
])
def test_flatten_order_and_text_match_jax(tree):
    import jax
    leaves, treedef = tree_flatten(tree)
    want_leaves, want_def = jax.tree.flatten(tree)
    assert len(leaves) == len(want_leaves)
    assert all(a is b for a, b in zip(leaves, want_leaves))
    assert str(treedef) == str(want_def)
    rebuilt = treedef.unflatten(leaves)
    assert tree_flatten(rebuilt)[0] == leaves


def test_flatten_namedtuple_keeps_field_order():
    import jax
    from repro_torch.core.fleet import FleetTrace
    ft = FleetTrace(*(torch.full((1, 2), i) for i in range(8)))
    leaves, treedef = tree_flatten({"ft": ft, "a": 0})
    assert leaves[0] == 0 and all(leaves[1 + i][0, 0] == i
                                  for i in range(8))
    assert "namedtuple[FleetTrace]" in str(treedef)
    assert str(treedef) == str(jax.tree.flatten({"ft": ft, "a": 0})[1])
    assert treedef.unflatten(leaves)["ft"] == ft


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_checkpoint_loads_in_the_other_package(tmp_path, writer):
    """Write with one package, load with the other: equal leaf bytes and
    dtypes; and both writers make the same payload and manifest
    fingerprint from the same slab."""
    slab = slab_np()
    dirs = {w: str(tmp_path / w) for w in ("repro", "port")}
    r_ckpt.Checkpointer(dirs["repro"]).save(7, as_repro(slab),
                                            blocking=True)
    t_ckpt.Checkpointer(dirs["port"]).save(7, as_port(slab), blocking=True)
    reader = t_ckpt if writer == "repro" else r_ckpt
    leaves, meta = reader.Checkpointer(dirs[writer]).load(step=7)
    keys = sorted(slab)
    assert meta["dtypes"] == ["bfloat16", "float32", "bool", "int32",
                              "int64"]
    for k, got in zip(keys, leaves):
        if k == "bf16":
            assert str(got.dtype).removeprefix("torch.") == "bfloat16"
            want = bf16_bits(as_repro(slab)["bf16"])
            np.testing.assert_array_equal(bf16_bits(got), want)
        else:
            assert got.dtype == slab[k].dtype and \
                got.tobytes() == slab[k].tobytes(), k
    step = "step_00000007"
    payload = [(tmp_path / w / step / LEAVES).read_bytes()
               for w in ("repro", "port")]
    assert payload[0] == payload[1]
    metas = [json.loads((tmp_path / w / step / MANIFEST).read_text())
             for w in ("repro", "port")]
    assert r_ckpt.manifest_fingerprint(metas[0]) == \
        manifest_fingerprint(metas[1])
    assert manifest_fingerprint(metas[0]) == manifest_fingerprint(metas[1])


def test_port_restores_a_repro_checkpoint_onto_torch(tmp_path):
    slab = slab_np()
    r_ckpt.Checkpointer(str(tmp_path)).save(1, as_repro(slab),
                                            blocking=True)
    out, step = Checkpointer(str(tmp_path)).restore(as_port(slab),
                                                    device="cpu")
    assert step == 1
    for k, want in as_port(slab).items():
        assert out[k].dtype == want.dtype and torch.equal(out[k], want), k


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_checksum_mismatch_raises_in_both(tmp_path, writer):
    slab = slab_np()
    if writer == "repro":
        r_ckpt.Checkpointer(str(tmp_path)).save(1, as_repro(slab),
                                                blocking=True)
    else:
        Checkpointer(str(tmp_path)).save(1, as_port(slab), blocking=True)
    payload = tmp_path / "step_00000001" / LEAVES
    raw = bytearray(payload.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    payload.write_bytes(bytes(raw))
    with pytest.raises(r_ckpt.ChecksumError):
        r_ckpt.Checkpointer(str(tmp_path)).load(step=1)
    with pytest.raises(ChecksumError):
        Checkpointer(str(tmp_path)).load(step=1)
    with pytest.raises(ChecksumError):
        Checkpointer(str(tmp_path)).restore(as_port(slab), step=1,
                                            device="cpu")


# ---------------------------------------------------------------------------
# supervisor, stragglers, backoff
# ---------------------------------------------------------------------------

class TestSupervisor:
    def test_restart_on_failure_resumes_from_checkpoint(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), keep=3)
        failures = {"armed": True}

        def step_fn(state, step):
            if step == 7 and failures["armed"]:
                failures["armed"] = False
                raise NodeFailure("simulated host loss")
            return state + 1, {"loss": float(state)}

        sup = Supervisor(
            step_fn=step_fn,
            save_fn=lambda s, st: ckpt.save(s, st, blocking=True),
            restore_fn=lambda: ckpt.restore(torch.zeros(()), device="cpu"),
            checkpoint_every=5)
        state, step, history, restarts = sup.run(torch.zeros(()), 0, 12)
        assert restarts == 1 and step == 12
        # work replays from step 5 (the last checkpoint)
        assert float(state) == 12 - 5 + 5
        assert torch.is_tensor(state) and len(history) == 12 + 2
        ref = r_fault.Supervisor(step_fn=None, save_fn=None,
                                 restore_fn=None)
        assert (sup.backoff.delays(), sup.checkpoint_every,
                sup.max_restarts) == (ref.backoff.delays(), 5,
                                      ref.max_restarts)

    def test_restarts_beyond_the_budget_raise(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path))

        def always(state, step):
            raise NodeFailure("host gone")

        sup = Supervisor(step_fn=always,
                         save_fn=lambda s, st: ckpt.save(s, st,
                                                         blocking=True),
                         restore_fn=lambda: (torch.zeros(()), 0),
                         max_restarts=2)
        with pytest.raises(NodeFailure):
            sup.run(torch.zeros(()), 0, 3)

    @pytest.mark.parametrize("case", ["spike", "scattered", "gap",
                                      "consecutive"])
    def test_straggler_events_equal_repro(self, case):
        """The same step-time streams through both policies fire at the
        same steps and record the same events."""
        streams = {
            "spike": (dict(window=8, threshold=2.0, max_flags=1),
                      [(i, 5.0 if i == 8 else 1.0) for i in range(10)]),
            "scattered": (dict(window=8, threshold=2.0, max_flags=2),
                          [(i, 5.0 if i in (8, 10) else 1.0)
                           for i in range(12)]),
            "gap": (dict(window=8, threshold=2.0, max_flags=2),
                    [(i, 1.0) for i in range(8)] + [(20, 5.0), (25, 5.0)]),
            "consecutive": (dict(window=8, threshold=2.0, max_flags=2),
                            [(i, 1.0) for i in range(8)]
                            + [(8, 5.0), (9, 5.0)]),
        }
        kw, stream = streams[case]
        port, ref = StragglerPolicy(**kw), r_fault.StragglerPolicy(**kw)
        fired = [(port.observe(s, t), ref.observe(s, t)) for s, t in stream]
        assert [a for a, _ in fired] == [b for _, b in fired]
        assert port.events == ref.events
        want = {"spike": [8], "scattered": [], "gap": [],
                "consecutive": [9]}[case]
        assert [s for (s, _), (hit, _) in zip(stream, fired) if hit] == want


class TestBackoff:
    def test_schedule_is_exponential_and_capped(self):
        b = Backoff(base_s=0.1, factor=2.0, cap_s=0.5, max_retries=5)
        assert b.delays() == [0.1, 0.2, 0.4, 0.5, 0.5]
        assert b.delays() == r_fault.Backoff(
            base_s=0.1, factor=2.0, cap_s=0.5, max_retries=5).delays()
        assert Backoff() == Backoff(base_s=0.05, factor=2.0, cap_s=5.0,
                                    max_retries=3)
        assert Backoff().delays() == r_fault.Backoff().delays()

    def test_zero_base_sleeps_instantly(self):
        b = Backoff(base_s=0.0, max_retries=3)
        t0 = time.time()
        for i in range(3):
            b.sleep(i)
        assert time.time() - t0 < 0.05
        assert b.delays() == [0.0, 0.0, 0.0]

    def test_logger_is_the_ports(self):
        from repro_torch.runtime import fault
        assert fault.log.name == "repro_torch.fault"
