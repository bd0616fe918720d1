"""Beyond-paper, on the PyTorch/CUDA port: schedule a real MoE dispatch
all-to-all with D1 coloring (the counterpart of
``examples/moe_a2a_schedule.py``).

Routes a token batch through the qwen3-moe smoke router, derives the
device→device traffic matrix under expert-parallel sharding (the
``all_to_all_single`` of ``models/moe.py::moe_apply_shard_map``), and
colors the transfer conflict graph (the paper's D1 on the line graph) into
contention-free phases, compared against the König lower bound.

Run:  PYTHONPATH=src python examples/moe_a2a_schedule_torch.py [--device cpu]
(``cuda`` by default.)
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.a2a_schedule import phase_lower_bound, schedule_a2a
from repro_torch.models import init_params

P_DEVICES = 8  # expert-parallel group size


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = torch.device(ap.parse_args(argv).device)

    cfg = get_smoke("qwen3_moe_30b_a3b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    router = params["blocks"]["moe"]["router"][0]          # (D, E) layer 0

    # 1. Route a batch of tokens.
    toks = torch.randn((P_DEVICES * 64, cfg.d_model), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(1))
    logits = toks @ router
    _, expert_ids = torch.topk(torch.softmax(logits, -1), cfg.experts_per_token)
    expert_ids = expert_ids.cpu().numpy()

    # 2. Expert-parallel traffic: token on device s -> expert e's device.
    experts_per_dev = cfg.n_experts // P_DEVICES
    src_dev = np.repeat(np.arange(P_DEVICES), 64 * cfg.experts_per_token)
    dst_dev = (expert_ids // experts_per_dev).reshape(-1)
    traffic = np.zeros((P_DEVICES, P_DEVICES))
    np.add.at(traffic, (src_dev, dst_dev), 1)
    print("traffic matrix (tokens):")
    print(traffic.astype(int))

    # 3. Color the transfer conflict graph into phases.
    phases = schedule_a2a(traffic, device=dev)
    lb = phase_lower_bound(traffic)
    print(f"\nD1-colored schedule: {len(phases)} contention-free phases "
          f"(König lower bound {lb})")
    for i, ph in enumerate(phases[:4]):
        print(f"  phase {i}: {ph}")
    if len(phases) > 4:
        print(f"  ... {len(phases) - 4} more")
    assert len(phases) <= 2 * lb
    return {"traffic": traffic, "phases": phases, "lb": lb}


if __name__ == "__main__":
    main()
