#!/usr/bin/env python3
"""How closely a DIN training step of librecommender_tpu_torch on the GPU
agrees with the same step on the CPU, over several parameter seeds.

    python3 bench_torch_din_agreement.py [--seeds 8] [--steps 10]

The model and the data are ``chip_smoke.py``'s DIN phase (embed_size=64,
batch_size=16384, hidden_units (128, 64, 32), recent_num=10 on ML-1M-sized
data with sex, age and genre). For each seed it prints one JSON line:

- ``grads``: the first step's gradients, GPU (through the gather, segment-sum
  and scatter-add kernels) against CPU, for every parameter with an entry
  beyond rtol 1e-4 + 1e-5 of its largest gradient or a difference whose norm
  is above 1e-5 of the gradient's: the entries beyond, the largest difference
  over the largest gradient, the norms' ratio;
- ``params``: after 1 step and after ``--steps`` steps of the same batches
  (``shuffle=False``, ``sampler="unconsumed"``), the largest difference and
  the entries beyond rtol 1e-4, atol 1e-5, GPU against CPU and one CPU run
  against another.

These numbers set the tolerances of ``chip_smoke.py``'s phase 5 (a).
"""
import argparse
import json
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs


def grad_rows(on_gpu, on_cpu):
    rows, bad_all, total = {}, 0, 0
    for k, want in on_cpu.items():
        d = np.abs(on_gpu[k].astype(np.float64) - want)
        top = max(float(np.abs(want).max()), 1e-300)
        bad = int((d > 1e-4 * np.abs(want) + 1e-5 * top).sum())
        norm = float(np.linalg.norm(d)
                     / max(np.linalg.norm(want.astype(np.float64)), 1e-300))
        bad_all += bad
        total += d.size
        if bad or norm > 1e-5:
            rows[k] = dict(largest=top, beyond=bad, entry=float(d.max()) / top,
                           norm=norm)
    return dict(beyond=bad_all, entries=total, by_parameter=rows)


def beyond(a, b, rtol=1e-4, atol=1e-5):
    worst, bad = 0.0, 0
    for k in a:
        d = np.abs(a[k] - b[k])
        worst = max(worst, float(d.max()))
        bad += int((d > atol + rtol * np.abs(b[k])).sum())
    return dict(max_abs=worst, beyond=bad)


def main():
    from librecommender_tpu_torch.data import DatasetFeat, TransformedSet
    from librecommender_tpu_torch.models import DIN

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=8)
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA GPU")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    train_cols, _ = cs.training_columns(np.random.default_rng(0))
    train, info = DatasetFeat.build_trainset(train_cols, **cs.FEAT_COLS)
    rows_a_step = cs.DIN_BATCH // 2

    for seed in range(1, args.seeds + 1):
        def din(device, **extra):
            m = DIN("ranking", info, embed_size=64, batch_size=cs.DIN_BATCH,
                    hidden_units=(128, 64, 32), recent_num=10, seed=seed,
                    device=device, **extra)
            m.pallas_grad_scatter = True
            return m

        init = din("cpu")
        init.build_model()
        init = init.params_to_arrays()
        _, on_gpu = cs.first_step_grads(din("cuda"), train, init)
        _, on_cpu = cs.first_step_grads(din("cpu"), train, init)
        out = dict(seed=seed, grads=grad_rows(on_gpu, on_cpu), params={})
        for steps in (1, args.steps):
            head = TransformedSet(*(x[: steps * rows_a_step] for x in (
                train.user_indices, train.item_indices, train.labels)))
            fitted = []
            for device in ("cuda", "cpu", "cpu"):
                m = din(device, n_epochs=1, sampler="unconsumed")
                m.params_from_arrays(init)
                m.fit(head, neg_sampling=True, verbose=0, shuffle=False)
                fitted.append(m.params_to_arrays())
            out["params"][f"{steps} step(s)"] = dict(
                gpu_cpu=beyond(fitted[0], fitted[1]),
                cpu_cpu=beyond(fitted[2], fitted[1]))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
