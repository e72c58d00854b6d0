"""Batched serving example (PyTorch/CUDA port): decode with a KV cache and
the merge-sort top-p sampler, on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""

import argparse

from repro_torch.launch import serve

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args()
    serve.main([
        "--arch", "qwen3-0.6b", "--smoke",
        "--requests", "4", "--prompt-len", "8", "--tokens", "24",
        "--sampler", "topp", "--device", args.device,
    ])
