"""End-to-end example (PyTorch/CUDA port): train a ~100M-param dense LM for
a few hundred steps with the full substrate (data pipeline with merge-sort
length bucketing, AdamW, checkpoints, restart), on the card unless
``--device cpu``.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]
"""

import argparse
import os
import tempfile

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import train as train_launch

# ~100M params: 12 x d512 dense blocks + 32k vocab (2 x 16M embeddings)
CONFIG_100M = ModelConfig(
    name="lm-100m",
    family="dense",
    n_layers=12,
    d_model=512,
    n_heads=8,
    n_kv_heads=4,
    d_ff=2048,
    vocab=32000,
    q_chunk=128,
    kv_chunk=128,
    remat="none",
)

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "mergeflow_100m_torch"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args()
    print(f"params: {CONFIG_100M.param_count() / 1e6:.1f}M")
    ARCHS["lm-100m"] = CONFIG_100M  # register for the launcher
    res = train_launch.main([
        "--arch", "lm-100m",
        "--steps", str(args.steps),
        "--batch", "2",
        "--seq", "128",
        "--lr", "3e-3",
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "100",
        "--device", args.device,
    ])
    losses = res["losses"]
    assert losses[-1] < losses[0], "loss must descend"
    print("ok")
