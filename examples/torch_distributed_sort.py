"""Distributed merge/sort over gloo ranks (PyTorch/CUDA port of the
``shard_map`` example): 8 rank processes, each on the card unless
``--device cpu``.

Demonstrates the ``strategy=`` switch of ``repro_torch.distributed``:
``allgather`` replicates the runs (O(N) per rank), ``corank`` distributes
the partition search, and ``exchange`` ships each rank exactly its
N/p-element block with the splitter-driven balanced all_to_all, no
replication.

    PYTHONPATH=src python examples/torch_distributed_sort.py [--device cpu] [--ranks 8]
"""

import argparse
import datetime
import multiprocessing
import socket

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import (
    distributed_merge,
    sharded_sort,
    sharded_sort_host,
)


def rank_main(rank: int, p: int, port: int, device: str, queue) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=p,
                            timeout=datetime.timedelta(seconds=300))
    try:
        dev = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
        if device == "cuda":
            torch.cuda.set_device(0)
        rng = np.random.default_rng(0)  # the same data on every rank
        m = n = 512 * p
        a = np.sort(rng.integers(0, 10_000, m)).astype(np.int32)
        b = np.sort(rng.integers(0, 10_000, n)).astype(np.int32)
        want = np.sort(np.concatenate([a, b]), kind="stable")
        sl = slice(rank * 512, (rank + 1) * 512)
        group = dist.group.WORLD
        lines = []
        for strategy in ("allgather", "corank"):
            out = distributed_merge(torch.tensor(a[sl], device=dev),
                                    torch.tensor(b[sl], device=dev), group,
                                    strategy=strategy)
            block = want[rank * 1024:(rank + 1) * 1024]
            assert (out.cpu().numpy() == block).all()
            lines.append(f"distributed merge [{strategy:9s}] over {p} ranks: "
                         f"ok (each rank produced exactly {(m + n) // p} "
                         f"elements)")
        x = rng.integers(-1000, 1000, p * 1024).astype(np.int32)
        want = np.sort(x, kind="stable")
        for strategy in ("allgather", "exchange"):
            out = sharded_sort(torch.tensor(x[rank * 1024:(rank + 1) * 1024],
                                            device=dev), group, strategy=strategy)
            assert (out.cpu().numpy() == want[rank * 1024:(rank + 1) * 1024]).all()
            lines.append(f"sharded sort    [{strategy:9s}] over {p} ranks: ok")
        # Uneven / non-power-of-two sizes via the host wrapper's padding.
        y = rng.normal(size=10_001).astype(np.float32)
        sy = sharded_sort_host(torch.tensor(y), strategy="exchange", device=dev)
        assert (sy.cpu().numpy() == np.sort(y, kind="stable")).all()
        lines.append(f"sharded_sort_host on n={len(y)} (uneven remainder): ok")
        queue.put((rank, lines))
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--ranks", type=int, default=8)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=rank_main,
                         args=(r, args.ranks, port, args.device, queue))
             for r in range(args.ranks)]
    for proc in procs:
        proc.start()
    results = {}
    try:
        while len(results) < len(procs):
            try:
                rank, lines = queue.get(timeout=5)
                results[rank] = lines
            except Exception:  # queue.Empty: see whether a rank died
                if any(proc.exitcode not in (None, 0) for proc in procs):
                    raise SystemExit(f"a rank failed: exit codes "
                                     f"{[p.exitcode for p in procs]}")
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
                proc.join()
    print("\n".join(results[0]))
    print("ok")


if __name__ == "__main__":
    main()
