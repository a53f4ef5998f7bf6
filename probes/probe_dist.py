"""Probe: which collectives gloo takes on CUDA tensors, DeviceMesh/DTensor
behaviour, and gloo's all_reduce rate on one card (2 ranks on cuda:0)."""
import os
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def attempt(rank, what, fn):
    try:
        out = fn()
        torch.cuda.synchronize()
        if rank == 0:
            print(f"OK   {what}: {out}", flush=True)
    except Exception as exc:  # noqa: BLE001 - a probe reports every failure
        if rank == 0:
            print(f"FAIL {what}: {type(exc).__name__}: {str(exc)[:200]}",
                  flush=True)


def run(rank, world, store):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    for dt in (torch.float32, torch.bfloat16, torch.int32, torch.uint8,
               torch.int8, torch.float16, torch.int64):
        x = (torch.arange(8, device=dev) + rank).to(dt)
        for op in ("SUM", "MAX", "MIN"):
            def f(x=x, op=op):
                y = x.clone()
                dist.all_reduce(y, op=getattr(dist.ReduceOp, op))
                return y.tolist()
            attempt(rank, f"all_reduce {op} {dt}", f)

        def ag(x=x):
            out = torch.empty(world * 8, dtype=x.dtype, device=dev)
            dist.all_gather_into_tensor(out, x)
            return out.tolist()
        attempt(rank, f"all_gather_into_tensor {dt}", ag)

        def ag2(x=x):
            outs = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(outs, x)
            return [o.tolist() for o in outs]
        attempt(rank, f"all_gather (list) {dt}", ag2)

        def rs(x=x):
            out = torch.empty(8 // world, dtype=x.dtype, device=dev)
            dist.reduce_scatter_tensor(out, x)
            return out.tolist()
        attempt(rank, f"reduce_scatter_tensor {dt}", rs)

        def bc(x=x):
            y = x.clone()
            dist.broadcast(y, src=0)
            return y.tolist()
        attempt(rank, f"broadcast {dt}", bc)

    def mesh():
        from torch.distributed.device_mesh import DeviceMesh
        m = DeviceMesh("cuda", torch.arange(world).reshape(1, world, 1),
                       mesh_dim_names=("pod", "data", "model"))
        return (m.get_coordinate(), m.size(1), m.get_local_rank("data"),
                m.get_group("data").size())
    attempt(rank, "DeviceMesh cuda (1, W, 1)", mesh)

    def sub():
        from torch.distributed.device_mesh import DeviceMesh
        m = DeviceMesh("cuda", torch.tensor([[[0]]]),
                       mesh_dim_names=("pod", "data", "model"))
        return (rank, m.get_coordinate())
    attempt(rank, "DeviceMesh over rank 0 only", sub)

    def dt_local():
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import DTensor, Replicate, Shard
        m = DeviceMesh("cuda", torch.arange(world), mesh_dim_names=("data",))
        loc = torch.full((2, 3), float(rank), device=dev)
        d = DTensor.from_local(loc, m, [Shard(0)], run_check=False,
                               shape=(2 * world, 3), stride=(3, 1))
        return (tuple(d.shape), d.to_local().tolist(),
                d.full_tensor().tolist())
    attempt(rank, "DTensor.from_local / full_tensor", dt_local)

    def nn_ar():
        import torch.distributed.nn.functional as F
        x = torch.full((4,), float(rank + 1), device=dev, requires_grad=True)
        y = F.all_reduce(x)
        (y * y).sum().backward()
        return (y.tolist(), x.grad.tolist())
    attempt(rank, "distributed.nn all_reduce + backward", nn_ar)

    for mb in (64, 512):
        n = mb * 2 ** 20 // 2
        x = torch.ones(n, dtype=torch.bfloat16, device=dev)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(3):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 3
        if rank == 0:
            print(f"rate all_reduce bf16 {mb} MB: {dt * 1e3:.1f} ms, "
                  f"{mb / 1024 / dt:.2f} GB/s", flush=True)
        x = x.view(torch.uint8)
        t0 = time.perf_counter()
        dist.all_reduce(x)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if rank == 0:
            print(f"rate all_reduce uint8 {mb} MB: {dt * 1e3:.1f} ms",
                  flush=True)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    print(sys.version, torch.__version__, torch.version.cuda,
          torch.cuda.device_count(), flush=True)
    d = tempfile.mkdtemp()
    mp.spawn(run, args=(2, os.path.join(d, "store")), nprocs=2, join=True)
    print("probe done", flush=True)
