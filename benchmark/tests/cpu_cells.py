"""Helpers of the benchmark's CPU tests: the repository on ``sys.path`` and
each cell driven through ``run.py`` on the CPU at a tiny size (64 rays a
step, 40x40 views, a 2^14-row hash table, no warm-up through a grid
refresh), with a fault planted under the timed call (:func:`planted`)."""

from __future__ import annotations

import contextlib
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SEED = 2 ** 31 + 12345
TINY = {"num_rays": 64}
TINY_HASH = {"log2_hashmap_size": 14}


def find(name):
    from benchmark import harness
    return harness.find_cell(name)


def tiny_options(cell):
    opts = cell.options()
    opts.update(TINY)
    if cell.config["options"]["encoding_pos"] != "cp":
        opts.update(TINY_HASH)
    return opts


@contextlib.contextmanager
def planted(fault):
    """The program broken underneath the timed call, its files untouched:
    ``unchanged`` skips every update of ``Trainer.train_step``,
    ``half_batch`` takes the loss over the first half of the rays."""
    import torch
    import envidr_tpu_torch.train.trainer as mod

    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if fault == "unchanged":
        def skip(trainer):
            for p in trainer.net.parameters():
                p.grad = None
        patch(mod.Trainer, "_apply_update", skip)
    elif fault == "half_batch":
        orig = mod.compute_losses

        def half(out, gt, *a, alpha_mask=None, **kw):
            h = gt.shape[0] // 2
            cut = {k: (v[:h] if torch.is_tensor(v) and v.dim() > 0 and v.shape[0] == gt.shape[0]
                       else v) for k, v in out.items()}
            return orig(cut, gt[:h], *a, alpha_mask=None if alpha_mask is None
                        else alpha_mask[:h], **kw)
        patch(mod, "compute_losses", half)
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


def run_cell(name: str, *, trace: bool = False, fault=None, seed: int = SEED):
    """(result line, records) of one tiny CPU run of cell ``name``."""
    import torch
    from benchmark import harness, run

    torch.set_num_threads(2)
    cell = find(name)
    kw = dict(options=tiny_options(cell), size=40)
    orig = harness.find_cell

    def small(n):
        c = orig(n)
        c.params.update(setup_steps=c.params["compare_steps"] + 1, warm_through_refresh=False)
        return c
    harness.find_cell = small
    try:
        with planted(fault):
            return run.run(name, seed, 0.5, trace, device=torch.device("cpu"), **kw)
    finally:
        harness.find_cell = orig
