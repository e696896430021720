"""Which collectives gloo runs on CUDA tensors with this installation of
PyTorch: the evidence behind ``core/collectives.py``'s ``GLOO_HOST_ONLY``
(and whether gloo has the reduce-scatter that ``reduce_scatter`` composes
from ``all_to_all`` under gloo)
(ranks that share one card talk over gloo, since NCCL refuses two ranks on
one GPU; the collectives gloo refuses with CUDA tensors are staged through
host memory there, the others run on gloo's own CUDA paths).

Each collective the port calls runs unstaged on a world of two gloo ranks
whose tensors lie on cuda:0, in a world of its own (a crash or a hang ends
only that world), and its result is checked. Prints one JSON object, also
written to ``chiprun_out/gloo_probe.json``:
``{"torch": ..., "cuda": ..., "collectives": {name: {"ok": bool,
"error": str or null}}}``. Exits 1 without a CUDA device.

    python3 chip_gloo_probe.py
"""
import datetime
import json
import os
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2
TIMEOUT_S = 90


def _op(name: str, rank: int) -> bool:
    """Run collective ``name`` on rank ``rank``'s CUDA tensors; True when
    the result is right."""
    dev = torch.device("cuda:0")
    if name == "all_reduce":
        x = torch.full((1000,), rank + 1.0, device=dev)
        dist.all_reduce(x)
        return bool((x == 3.0).all())
    if name == "all_to_all_single":
        x = torch.tensor([10 * rank, 10 * rank + 1], dtype=torch.uint8,
                         device=dev)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out.tolist() == [rank, 10 + rank]
    if name == "all_gather":
        x = torch.full((3,), rank + 5, dtype=torch.uint8, device=dev)
        out = torch.empty((WORLD, 3), dtype=torch.uint8, device=dev)
        dist.all_gather(list(out.unbind(0)), x)
        return out.tolist() == [[5] * 3, [6] * 3]
    if name == "reduce_scatter_tensor":
        x = torch.arange(4, dtype=torch.float32, device=dev) + rank
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, x)
        return out.tolist() == ([1.0, 3.0] if rank == 0 else [5.0, 7.0])
    if name in ("send_recv", "send_recv_uint8"):
        dtype = torch.uint8 if name.endswith("uint8") else torch.float32
        if rank == 0:
            dist.send(torch.arange(16, device=dev).to(dtype), 1)
            return True
        x = torch.zeros(16, dtype=dtype, device=dev)
        dist.recv(x, 0)
        return x.tolist() == torch.arange(16).to(dtype).tolist()
    raise ValueError(name)


# as core/collectives.py calls them (all_gather into views of one tensor)
OPS = ("all_reduce", "all_to_all_single", "all_gather", "send_recv",
       "send_recv_uint8", "reduce_scatter_tensor")


def _rank(rank: int, name: str, store_path: str, out) -> None:
    try:
        store = dist.FileStore(store_path, WORLD)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=WORLD,
            timeout=datetime.timedelta(seconds=TIMEOUT_S // 2))
        try:
            ok = _op(name, rank)
            torch.cuda.synchronize()
            out.put((rank, ok, None if ok else "wrong result"))
        finally:
            dist.destroy_process_group()
    except Exception as e:
        out.put((rank, False, f"{type(e).__name__}: {e}"[:400]))
        traceback.print_exc()


def probe(name: str, tmp: str) -> dict:
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(tmp, f"store_{name}")
    procs = [ctx.Process(target=_rank, args=(r, name, store, out))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    got = []
    while not out.empty():
        got.append(out.get())
    errors = sorted({e for _, ok, e in got if not ok and e})
    if hung:
        errors.append(f"{len(hung)} rank(s) hung past {TIMEOUT_S} s")
    if len(got) < WORLD and not hung:
        errors.append("a rank died: exit codes "
                      f"{[p.exitcode for p in procs]}")
    ok = not errors and len(got) == WORLD and all(g[1] for g in got)
    return {"ok": ok, "error": "; ".join(errors) or None}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_gloo_probe: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="gloo_probe_") as tmp:
        res = {"torch": torch.__version__, "cuda": torch.version.cuda,
               "device": torch.cuda.get_device_name(0),
               "collectives": {name: probe(name, tmp) for name in OPS}}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "gloo_probe.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
