#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 14 (AOT export and native programs) alone on
one GPU, on full-width models of random parameters instead of phases 5-9's
fits.

    python3 bench_torch_export.py

Builds the kernels and the interpreter's runner (phase 0), makes phase 4's
ML-1M-sized data from seed 0, builds the thirteen models phase 14 reads at
the widths phases 5-9 train them (DIN's, the sequence and feature families',
RNN4Rec gru, Caser, WaveNet and YouTubeRetrieval; parameters from each
model's seed, no fit), saves them into a work directory under phase 14's
names, then runs ``chip_smoke.phase_export`` on them: its lines, its
``{"phase14_export": ...}`` JSON line, and the phase's seconds.
"""
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    pool = cs.export_pool()   # as in chip_smoke.py: imports during the build
    cs.log(cs.phase_card_and_build())
    from librecommender_tpu_torch import models
    from librecommender_tpu_torch.data import DatasetFeat

    columns = cs.training_columns(rng)
    _, _, pinfo = cs.training_data(columns)
    _, finfo = DatasetFeat.build_trainset(columns[0], **cs.FEAT_COLS)
    din_kw = dict(hidden_units=(128, 64, 32), recent_num=10)
    specs = {"din": ("DIN", finfo, din_kw)}
    for name, (cls, kw) in cs.SEQ_FAMILY.items():
        specs[name] = (cls, finfo, {**din_kw, **kw})
    for name, (cls, kw) in cs.FEAT_FAMILY.items():
        specs[name] = (cls, finfo, kw)
    for name in ("rnn4rec_gru", "caser", "wave_net"):
        cls, kw = cs.EMBED_FAMILY[name]
        specs[name] = (cls, pinfo, kw)
    cls, _, kw = cs.RETRIEVAL_GRAPH["youtube_retrieval"]
    specs["youtube_retrieval"] = (cls, finfo, kw)
    here = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(dir=here, prefix="smoke_",
                                     suffix="_artifacts") as workdir:
        t = time.perf_counter()
        for name, (cls, info, kw) in specs.items():
            model = getattr(models, cls)("ranking", info, embed_size=64,
                                         device="cuda", **kw)
            model.build_model()
            model.post_fit()
            model.save(workdir, name)
        cs.log(f"[bench export] built and saved {len(specs)} models in "
               f"{time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        launches = cs.phase_export(rng, workdir, pool)
        cs.log(f"[bench export] phase 14 {time.perf_counter() - t:.1f} s; "
               f"2.1 launches {launches}")


if __name__ == "__main__":
    main()
