"""Probe 2: which DTensor call crashes on gloo ranks of one card, then the
port's multi-rank smoke worlds (tests/torch_dp_workers.py) on cuda:0,
then gloo's all_reduce rate there."""
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))


def case(rank, world, store, name):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard
    m = DeviceMesh("cuda", torch.arange(world), mesh_dim_names=("data",))
    print(f"[{name}] rank {rank}: mesh ok", flush=True)
    if name == "submesh":
        s = DeviceMesh("cuda", torch.tensor([0]), mesh_dim_names=("data",))
        print(f"[{name}] rank {rank}: coordinate {s.get_coordinate()}",
              flush=True)
    loc = torch.full((2, 3), float(rank), device=dev)
    if name in ("from_local", "full_tensor"):
        d = DTensor.from_local(loc, m, [Shard(0)], run_check=False,
                               shape=(2 * world, 3), stride=(3, 1))
        with torch.no_grad():
            d.to_local().mul_(2)
        print(f"[{name}] rank {rank}: from_local ok {d.to_local().tolist()}",
              flush=True)
        if name == "full_tensor":
            print(f"[{name}] rank {rank}: {d.full_tensor().tolist()}",
                  flush=True)
    dist.barrier()
    dist.destroy_process_group()


def rate(rank, world, store):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    for dt, mb in ((torch.bfloat16, 512), (torch.float32, 512),
                   (torch.uint8, 512)):
        n = mb * 2 ** 20 // torch.tensor([], dtype=dt).element_size()
        x = torch.ones(n, dtype=dt, device=dev)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(3):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        dt_s = (time.perf_counter() - t0) / 3
        if rank == 0:
            print(f"rate: all_reduce {dt} {mb} MB over {world} gloo ranks on "
                  f"cuda:0: {dt_s * 1e3:.1f} ms ({mb / 1024 / dt_s:.2f} GB/s)",
                  flush=True)
    dist.destroy_process_group()


def spawn(fn, world, *args):
    d = tempfile.mkdtemp()
    try:
        mp.spawn(fn, args=(world, os.path.join(d, "store")) + args,
                 nprocs=world, join=True)
        return "ok"
    except Exception as exc:  # noqa: BLE001 - the probe reports each case
        return f"{type(exc).__name__}: {str(exc)[:300]}"


if __name__ == "__main__":
    print(torch.__version__, torch.cuda.get_device_name(0), flush=True)
    for name in ("submesh", "from_local", "full_tensor"):
        print(f"case {name}: {spawn(case, 2, name)}", flush=True)
    import torch_dp_workers as W
    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.api import build_model
    from repro_torch.models.params import leaves, unflatten
    from repro_torch.sharding.ranks import spawn_ranks
    torch.backends.cuda.matmul.allow_tf32 = False
    start = {}
    for arch in W.ARCHS:
        m = build_model(get_smoke_config(arch), "cpu")
        p = m.init(torch.Generator().manual_seed(0), torch.float32)
        start[arch] = unflatten((path, t.numpy()) for (path, _), t in
                                zip(leaves(m.spec), tree_flatten(p)[0]))
    rng = np.random.default_rng(0)
    fwd = (rng.standard_normal((8, 16, 16)).astype(np.float32) * 0.3,
           np.zeros((8, 16), np.float32),
           rng.standard_normal((8, 16)).astype(np.float32))
    bwd = (rng.standard_normal((4, 16, 16)).astype(np.float32) * 0.3,
           np.zeros((4, 16), np.float32),
           rng.standard_normal((4, 16)).astype(np.float32))
    tokens = W.global_batch(512, 9, 1)[:4]
    for world in (2, 4):
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            try:
                res = spawn_ranks(W.world_rank, world, "gloo", device,
                                  args=(start, tokens, fwd, bwd))
            except Exception as exc:  # noqa: BLE001
                print(f"world {world} {device}: {type(exc).__name__}: "
                      f"{str(exc)[-1500:]}", flush=True)
                continue
            r0 = res[0]
            same = all(all(torch.equal(a, b) for a, b in zip(
                r0["dp"][arch][s]["params"], r["dp"][arch][s]["params"]))
                for r in res for arch in W.ARCHS for s in range(3))
            print(f"world {world} {device}: {time.perf_counter() - t0:.1f} s,"
                  f" ranks' params bitwise equal {same}; metrics "
                  + str({a: [r0['dp'][a][s]['metrics']['loss']
                             for s in range(3)] for a in W.ARCHS})
                  + f"; psum {r0['psum'].flatten()[:4].tolist()}; refused "
                  f"{[n for n, e in r0['refused'] if e]}", flush=True)
            if world == 2:
                e = r0["elastic"]
                print(f"  elastic {all(e['params_equal'])} "
                      f"{all(e['mu_equal'])} loss {e['loss']}", flush=True)
            else:
                print(f"  pipeline loss {r0['pipeline']['loss']}", flush=True)
    print(f"rate: {spawn(rate, 2)}", flush=True)
    print("probe done", flush=True)
