"""Readers of the program's own spans and counters (``envidr_tpu_torch/obs.py``),
shared by the files of ``metrics/`` as ``readers.py``'s are.

The program records its spans while a ``torch.profiler`` profile runs, so
the traced stretch of a ``--trace 1`` run (``harness.profiled``) records
them, one root span ``train_step`` a step, and the untraced window runs with
them off.  Each reader takes ``obs.snapshot()`` after that stretch: device
ms per span (CUDA events on the step's one stream) and the counters each
step's root gathered.  Each returns None where nothing was recorded: a
program without spans, an untraced run, or, for the device-ms readers, a
run without a card."""

from __future__ import annotations

from benchmark.harness import median

STEP = "train_step"


def _steps(run):
    """(snapshot, indices of its closed ``train_step`` roots), or None."""
    if getattr(run, "kind", None) != "train" or run.trace is None:
        return None
    try:
        from envidr_tpu_torch import obs
    except ImportError:           # a program without spans
        return None
    snap = obs.snapshot()
    roots = snap.roots(STEP)
    return (snap, roots) if roots else None


def _ms_by_step(run, names, under="render"):
    """Per traced step, the summed device ms of the spans called one of
    ``names`` that lie under a span ``under`` (None: anywhere in the step);
    None if any of them has no device time."""
    found = _steps(run)
    if found is None:
        return None
    snap, roots = found
    per = {r: 0.0 for r in roots}
    for i, s in enumerate(snap.spans):
        if s.root not in per or s.name not in names:
            continue
        if under is not None and under not in snap.path(i)[:-1]:
            continue
        if s.device_ms is None:
            return None
        per[s.root] += s.device_ms
    return [per[r] for r in roots]


def _median_ms(run, names, under="render"):
    ms = _ms_by_step(run, names, under)
    return None if ms is None else median(ms)


def march_ms(run):
    """Median over the traced steps of the ``march`` spans' device ms under
    ``render``: the occupancy-grid march.  Moves the cell's train rays/s."""
    return _median_ms(run, ("march",))


def encode_ms(run):
    """Median over the traced steps of the summed ``encode`` spans' device ms
    under ``render``: the position encoder's forward (CP or hash).  The grid
    refresh's encodes, under ``grid.refresh``, are left out.  Moves the
    cell's train rays/s."""
    return _median_ms(run, ("encode",))


def network_ms(run):
    """Median over the traced steps of the ``geometry`` and ``color`` spans'
    device ms under ``render`` less their ``encode`` spans: the SDF net, the
    normals' input gradient, the IDE and the env, diffuse and colour MLPs,
    forward.  Moves the cell's train rays/s."""
    both = _ms_by_step(run, ("geometry", "color"))
    enc = _ms_by_step(run, ("encode",))
    if both is None or enc is None:
        return None
    return median([a - b for a, b in zip(both, enc)])


def backward_ms(run):
    """Median over the traced steps of the ``backward`` span's device ms:
    ``loss.backward()``, every layer's gradients, the tables' and the eikonal
    double backward.  Moves the cell's train rays/s."""
    return _median_ms(run, ("backward",), under=None)


def _counted(run, name):
    """(the counter ``name`` summed over the traced steps, their count)."""
    found = _steps(run)
    if found is None:
        return None
    snap, roots = found
    return sum(snap.spans[r].counters.get(name, 0) for r in roots), len(roots)


def host_syncs_per_step(run):
    """Blocking reads a traced step, as the program counts them: ``host_sync``
    (the reads it makes on purpose: the epoch's mean count) and
    ``host_sync.implicit`` (each synchronising call the sync debug mode
    reports inside the step).  Moves the cell's train rays/s: a sync drains
    the device's queue."""
    made, implicit = _counted(run, "host_sync"), _counted(run, "host_sync.implicit")
    if made is None:
        return None
    return (made[0] + implicit[0]) / made[1]


def march_slot_use(run):
    """Share of the march's K x N sample slots that hold a sample, in percent,
    over the traced steps: ``march.samples`` (the step's mean count times its
    rays) over ``march.slots`` (rays times K).  The encoder and the network
    run on every slot.  Moves the cell's train rays/s."""
    samples, slots = _counted(run, "march.samples"), _counted(run, "march.slots")
    if samples is None or not slots[0]:
        return None
    return 100.0 * samples[0] / slots[0]
