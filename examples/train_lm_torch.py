"""End-to-end driver on the PyTorch/CUDA port: train a dense LM for a few
hundred steps (the counterpart of ``examples/train_lm.py``).

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--device cpu]
(``cuda`` by default.)  Small by default (~14M params); pass --full-100m for
the 100M model (same code path).  Checkpoints + restart + watchdog are
live: kill it mid-run and rerun to see it resume.
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import train_loop
from repro_torch.models.config import ModelConfig


def cfg_100m() -> ModelConfig:
    return ModelConfig(
        name="dense-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32000,
        dtype="float32", remat="none")


def cfg_small() -> ModelConfig:
    return ModelConfig(
        name="dense-14m", family="dense", n_layers=4, d_model=256,
        n_heads=8, n_kv_heads=4, d_ff=1024, vocab_size=8192,
        dtype="float32", remat="none")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    cfg = cfg_100m() if args.full_100m else cfg_small()
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params")
    _, hist = train_loop(
        cfg, steps=args.steps, global_batch=8, seq_len=128,
        ckpt_dir=args.ckpt_dir, ckpt_every=50, device=args.device)
    print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"over {len(hist)} steps")
    assert hist[-1]["loss"] < hist[0]["loss"]
    return hist


if __name__ == "__main__":
    main()
