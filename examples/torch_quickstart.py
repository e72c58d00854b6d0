"""Quickstart (PyTorch/CUDA port): the paper's co-rank merge in five
minutes, on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import (
    co_rank,
    merge_partitioned,
    merge_sort,
    merge_topk,
    partition_bounds,
)
from repro_torch.kernels.merge import merge_tiled


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    dev = torch.device(ap.parse_args(argv).device)

    rng = np.random.default_rng(0)
    a = torch.tensor(np.sort(rng.integers(0, 100, 1000)), dtype=torch.int32,
                     device=dev)
    b = torch.tensor(np.sort(rng.integers(0, 100, 1500)), dtype=torch.int32,
                     device=dev)

    # 1. Co-ranking (Algorithm 1): which prefixes of A and B make up C[0:800]?
    res = co_rank(800, a, b)
    print(f"co_rank(i=800) -> j={int(res.j)}, k={int(res.k)} "
          f"({int(res.iterations)} iterations, bound=log2 min(m,n)~10)")

    # 2. Perfectly load-balanced parallel merge (Algorithm 2): 8 lanes, each
    #    merges exactly ceil(2500/8) elements.
    c = merge_partitioned(a, b, p=8)
    bounds = partition_bounds(2500, 8).cpu().numpy()
    print("per-PE elements:", np.diff(bounds).tolist())
    want = np.sort(np.concatenate([a.cpu().numpy(), b.cpu().numpy()]),
                   kind="stable")
    assert (c.cpu().numpy() == want).all()

    # 3. The merge kernel (merge_tile: CUDA on the card, its plain version
    #    on the CPU): same answer.
    ck = merge_tiled(a, b)
    assert torch.equal(ck, c)
    print(f"merge_tile kernel matches ({dev.type}):", True)

    # 4. Everything built on it: stable sort and top-k.
    x = torch.tensor(rng.standard_normal(4096), dtype=torch.float32, device=dev)
    s = merge_sort(x)
    assert torch.equal(s, torch.sort(x, stable=True).values)
    vals, idx = merge_topk(x, 5)
    print("top-5:", vals.cpu().numpy().round(3).tolist())
    print("ok")


if __name__ == "__main__":
    main()
