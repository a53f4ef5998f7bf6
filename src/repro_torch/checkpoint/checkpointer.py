"""Fault-tolerant checkpointing: async, atomic, restorable onto a device.

The counterpart of `repro.checkpoint.checkpointer`, on the same on-disk
format, so a checkpoint written by either package loads in the other:

* **Atomic commit** — a checkpoint directory ``step_%08d/`` is written
  under a temp name and renamed into place (`os.replace`), then a
  `COMMIT` marker is fsynced; restore only considers committed
  checkpoints, so a worker dying mid-save can never leave a
  half-checkpoint that gets loaded.
* **Payload** — ``leaves.npz`` holds one array ``leaf_i`` per pytree leaf
  in flatten order; ``manifest.json`` holds the step, the structure, the
  leaf count, shapes and dtypes, the wall clock and the payload's
  sha256.  Leaves whose dtype numpy cannot hold (bfloat16, float8) are
  stored as raw ``uint8`` bytes under their dtype's name and viewed back
  through `torch` on load.
* **Async save** — the host snapshot is taken synchronously, a copy of
  every leaf (a CPU tensor or numpy array too: `repro`'s arrays are
  immutable, the port's tensors are not, and a training step updates
  them in place while the snapshot is written); serialization runs on a
  background thread; `wait()` joins before the next save or shutdown.

The pytree flatten is the port's own (dict, list, tuple, NamedTuple and
None nodes; anything else is a leaf), in `jax.tree.flatten`'s order —
dict keys sorted, NamedTuple fields in declaration order — and its
structure string is the one `jax` writes into the manifest, so identical
state gives identical manifests in both packages.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device


class ChecksumError(RuntimeError):
    """A committed checkpoint's payload does not match its manifest
    checksum — a torn/corrupted write.  Callers treat the step as not
    done (recompute) rather than deserializing garbage."""

# numpy's npz cannot represent bfloat16 or fp8: store raw bytes (uint8
# view) and re-view on load using the manifest dtype.
_RAW_DTYPES = {"bfloat16", "float8_e4m3fn", "float8_e5m2"}

COMMIT = "COMMIT"
MANIFEST = "manifest.json"
LEAVES = "leaves.npz"

# Manifest keys that may differ between two saves of identical state
# (wall clock).  They exist for humans and GC ordering only and stay out
# of every fingerprint-covered byte: the payload checksum (`sha256`)
# hashes LEAVES alone, and `manifest_fingerprint` strips these keys, so
# resume identity never depends on *when* a checkpoint was written.
VOLATILE_META = ("time",)


def manifest_fingerprint(meta: Dict[str, Any]) -> str:
    """sha256 over the manifest's deterministic content — everything
    except `VOLATILE_META` keys.  Two saves of bitwise-identical state
    produce the same fingerprint regardless of wall clock."""
    stable = {k: v for k, v in meta.items() if k not in VOLATILE_META}
    blob = json.dumps(stable, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


# ---------------------------------------------------------------------------
# pytree flatten
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


class TreeDef:
    """The structure of a flattened pytree: `unflatten` rebuilds it from
    a leaf list, `str` gives `jax`'s ``PyTreeDef(...)`` text."""

    def __init__(self, kind: str, children=(), meta=None):
        self.kind = kind              # leaf | none | dict | list | tuple
        self.children = tuple(children)     # | namedtuple
        self.meta = meta              # dict keys or the NamedTuple class
        self.n_leaves = (1 if kind == "leaf"
                         else sum(c.n_leaves for c in self.children))

    def _text(self) -> str:
        inner = ", ".join(c._text() for c in self.children)
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c._text()}" for k, c in
                                   zip(self.meta, self.children)) + "}"
        if self.kind == "list":
            return f"[{inner}]"
        if self.kind == "tuple":
            return f"({inner},)" if len(self.children) == 1 else f"({inner})"
        return f"CustomNode(namedtuple[{self.meta.__name__}], [{inner}])"

    def __str__(self) -> str:
        return f"PyTreeDef({self._text()})"

    def unflatten(self, leaves):
        it = iter(leaves)
        out = self._build(it)
        if next(it, None) is not None:
            raise ValueError("more leaves than the structure holds")
        return out

    def _build(self, it):
        if self.kind == "leaf":
            return next(it)
        if self.kind == "none":
            return None
        kids = [c._build(it) for c in self.children]
        if self.kind == "dict":
            return dict(zip(self.meta, kids))
        if self.kind == "list":
            return kids
        if self.kind == "tuple":
            return tuple(kids)
        return self.meta(*kids)


def tree_flatten(tree) -> Tuple[List[Any], TreeDef]:
    """`(leaves, treedef)` in `jax.tree.flatten`'s order."""
    leaves: List[Any] = []

    def walk(x) -> TreeDef:
        if x is None:
            return TreeDef("none")
        if isinstance(x, dict):
            keys = sorted(x)
            return TreeDef("dict", [walk(x[k]) for k in keys], keys)
        if _is_namedtuple(x):
            return TreeDef("namedtuple", [walk(v) for v in x], type(x))
        if isinstance(x, (list, tuple)):
            return TreeDef("list" if isinstance(x, list) else "tuple",
                           [walk(v) for v in x])
        leaves.append(x)
        return TreeDef("leaf")

    treedef = walk(tree)
    return leaves, treedef


# ---------------------------------------------------------------------------
# leaves on the host
# ---------------------------------------------------------------------------

def _to_host(x) -> Tuple[np.ndarray, str]:
    """(a host copy of `x` as the array stored in the npz, its manifest
    dtype string)."""
    if torch.is_tensor(x):
        t = x.detach().to("cpu", copy=True,
                          memory_format=torch.contiguous_format)
        name = str(t.dtype).removeprefix("torch.")
        if name in _RAW_DTYPES:
            return t.view(torch.uint8).numpy(), name
        return t.numpy(), name
    a = np.array(x)
    if str(a.dtype) in _RAW_DTYPES:         # an ml_dtypes array
        return a.view(np.uint8), str(a.dtype)
    return a, str(a.dtype)


def _decode(x: np.ndarray, dtype_str: str):
    """A stored leaf back in its own dtype: a numpy array, or a CPU
    tensor for the dtypes numpy lacks."""
    if dtype_str in _RAW_DTYPES:
        return torch.from_numpy(np.ascontiguousarray(x)).view(
            getattr(torch, dtype_str))
    return x


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _as_torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype)).dtype


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ---------------- save ----------------
    def save(self, step: int, state: Any, blocking: bool = False):
        """Snapshot `state` (any pytree of tensors or arrays) at `step`."""
        self.wait()
        leaves, treedef = tree_flatten(state)
        host = [_to_host(x) for x in leaves]
        meta = {
            "step": int(step),
            "treedef": str(treedef),
            "n_leaves": len(host),
            "shapes": [list(x.shape) if torch.is_tensor(x)
                       else list(a.shape) for x, (a, _) in zip(leaves, host)],
            "dtypes": [d for _, d in host],
            "time": time.time(),
        }

        def write():
            final = os.path.join(self.dir, f"step_{step:08d}")
            tmp = final + ".tmp"
            for p in (tmp, final):
                if os.path.exists(p):
                    shutil.rmtree(p)      # re-save of the same step
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, LEAVES),
                     **{f"leaf_{i}": a for i, (a, _) in enumerate(host)})
            # checksum the serialized payload so restore/load can tell a
            # torn write from a committed checkpoint
            meta["sha256"] = _sha256(os.path.join(tmp, LEAVES))
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)        # atomic publish
            with open(os.path.join(final, COMMIT), "w") as f:
                f.write(str(meta["time"]))
                f.flush()
                os.fsync(f.fileno())
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        return step

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------- restore ----------------
    def all_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            full = os.path.join(self.dir, name)
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and os.path.exists(os.path.join(full, COMMIT))):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _read(self, step: int, verify: bool):
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, MANIFEST)) as f:
            meta = json.load(f)
        leaves_path = os.path.join(path, LEAVES)
        # pre-checksum checkpoints (older writers) skip verification
        if verify and "sha256" in meta and _sha256(leaves_path) != meta["sha256"]:
            raise ChecksumError(
                f"checkpoint step {step} in {self.dir}: payload checksum "
                f"mismatch (torn write); treat as not done")
        return np.load(leaves_path), meta

    def _step(self, step: Optional[int]) -> int:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        return step

    def load(self, step: Optional[int] = None,
             verify: bool = True) -> Tuple[List[Any], dict]:
        """Host-side read of a committed checkpoint: `(leaves, meta)` —
        the flat leaf list (numpy arrays; CPU tensors for bfloat16 and
        float8 leaves) plus the manifest — with no device placement and
        no target structure required (the resilient sweep path stores
        plain dict-of-array slabs).  `verify=True` checks the payload
        checksum and raises `ChecksumError` on mismatch."""
        step = self._step(step)
        data, meta = self._read(step, verify)
        leaves = [_decode(data[f"leaf_{i}"], meta["dtypes"][i])
                  for i in range(meta["n_leaves"])]
        return leaves, meta

    def restore(self, target: Any, step: Optional[int] = None,
                shardings: Any = None, device=None, verify: bool = True):
        """Restore into the structure of `target` (a pytree of tensors or
        arrays), each leaf cast to its target leaf's dtype.  Returns
        `(state, step)`.

        Placement follows `repro`'s ``jax.device_put``: by default every
        leaf goes to the card (``"cuda"``, which raises without one);
        `shardings`, a pytree of the same structure as `target` whose
        leaves are `torch.device`s or device strings, places each leaf
        on its own device; `device` names one device for every leaf
        (``device="cpu"`` for the host)."""
        if shardings is not None and device is not None:
            raise ValueError("restore takes `shardings` or `device`, not "
                             "both")
        step = self._step(step)
        data, meta = self._read(step, verify)
        leaves, treedef = tree_flatten(target)
        if len(leaves) != len(data.files):
            raise ValueError(
                f"checkpoint has {len(data.files)} leaves, target expects "
                f"{len(leaves)} — structure mismatch")
        if shardings is not None:
            places, sh_def = tree_flatten(shardings)
            if str(sh_def) != str(treedef):
                raise ValueError(
                    f"shardings {sh_def} do not match the target's "
                    f"structure {treedef}")
            devs = [resolve_device(d) for d in places]
        else:
            devs = [resolve_device("cuda" if device is None
                                   else device)] * len(leaves)
        out = []
        for i, (ref, dev) in enumerate(zip(leaves, devs)):
            x = _decode(data[f"leaf_{i}"], meta["dtypes"][i])
            # np.ascontiguousarray gives a 0-d leaf one axis: keep its shape
            t = x if torch.is_tensor(x) else torch.from_numpy(
                np.ascontiguousarray(x)).reshape(x.shape)
            if hasattr(ref, "dtype"):
                t = t.to(_as_torch_dtype(ref.dtype))
            out.append(t.to(dev))
        return treedef.unflatten(out), step
