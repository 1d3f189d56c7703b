"""Readers of the interreflection cell's per-layer metrics, built on
``spans.py``'s and ``readers.py``'s: the device ms of the three passes'
spans and of the renv branch, the share of rays that reflect, the secondary
march's slot use, and the step's model FLOPs over the window.

The program names each pass a span (``render/indirect.py``:
``indirect.geometry``, ``indirect.reflect``, ``indirect.main``) and the renv
branch ``renv`` (``models/network.py``), and counts ``indirect.rays``,
``indirect.ref_rays``, ``indirect.geometry.samples``,
``indirect.reflect.slots``, ``indirect.reflect.samples``, and pass 3's
``march.samples``.  Each reader returns None where the run holds nothing to
read: an untraced run, a run without a card (device ms), or a program
without these spans and counters."""

from __future__ import annotations

from benchmark import readers, spans
from benchmark.harness import median

RENV_DIMS = [4, 64, 64, 64]      # renv_net's input and hidden widths (network.py:303-310)


def _span_ms(run, name):
    """Median over the traced steps of the summed device ms of the spans
    ``name``, or None where a traced step has none of them (a program
    without the span: ``spans._ms_by_step`` would read 0) or no device ms."""
    found = spans._steps(run)
    if found is None:
        return None
    snap, roots = found
    per = {r: None for r in roots}
    for s in snap.spans:
        if s.root in per and s.name == name:
            if s.device_ms is None:
                return None
            per[s.root] = (per[s.root] or 0.0) + s.device_ms
    if any(v is None for v in per.values()):
        return None
    return median(list(per.values()))


def indirect_geometry_ms(run):
    """Median device ms a traced step of pass 1, ``indirect.geometry``: the
    march, the SDF and the normals' input gradient, and the composite of the
    normals, depth and opacity.  Moves the cell's train rays/s."""
    return _span_ms(run, "indirect.geometry")


def indirect_reflect_ms(run):
    """Median device ms a traced step of pass 2, ``indirect.reflect``: the
    reflected rays' march from the surface, their geometry and colour.
    Moves the cell's train rays/s."""
    return _span_ms(run, "indirect.reflect")


def indirect_main_ms(run):
    """Median device ms a traced step of pass 3, ``indirect.main``: the main
    render with the renv branch.  Moves the cell's train rays/s."""
    return _span_ms(run, "indirect.main")


def renv_ms(run):
    """Median device ms a traced step of the renv branch, ``renv`` (inside
    pass 3's colour): the gate, ``renv_net`` and the colour head's second
    pass on every sample slot, the blend.  Moves the cell's train rays/s."""
    return _span_ms(run, "renv")


def _counters(run, *names):
    """The counters ``names`` summed over the traced steps
    (``spans._counted``), or None where a program counts none of the first."""
    got = [spans._counted(run, n) for n in names]
    if got[0] is None or not got[0][0]:
        return None
    return [g[0] for g in got]


def indirect_ref_ray_share(run):
    """Share of the rays whose reflection mask is on (pass 1's opacity above
    0.9), in percent over the traced steps: ``indirect.ref_rays`` over
    ``indirect.rays``.  Every ray marches pass 2; the masked ones carry zeros.
    Moves the cell's train rays/s."""
    got = _counters(run, "indirect.rays", "indirect.ref_rays")
    return None if got is None else 100.0 * got[1] / got[0]


def indirect_reflect_slot_use(run):
    """Share of pass 2's N x K2 sample slots that hold a sample, in percent
    over the traced steps: ``indirect.reflect.samples`` over
    ``indirect.reflect.slots``.  The encoder and the networks run on every
    slot.  Moves the cell's train rays/s."""
    got = _counters(run, "indirect.reflect.slots", "indirect.reflect.samples")
    return None if got is None else 100.0 * got[1] / got[0]


def step_flops(o) -> dict:
    """FLOPs of one marched sample of each pass over the step (forward and
    backward), by ``readers.flops_per_sample``'s convention (a multiply-add
    2 FLOPs, a linear layer in -> out 2 in out, biases, activations, the IDE
    and the compositing left out).  With S the encoder plus the SDF net,
    C the env net twice, D the diffuse net, H the colour net and R
    ``renv_net`` [4, 64 x 3, env feature]:

      * pass 1 (geometry only): forward S, the normals' input gradient with
        ``create_graph`` (S) and the backward of both (2 S + 2 S): the loss
        reaches pass 1 through the depth (grad rays) and the normals (the
        reflected direction): 6 S;
      * pass 2: forward F2 = S + C + D + H, its backward 2 F2, the input
        gradient S and its backward 2 S: 3 F2 + 3 S;
      * pass 3: forward F3 = F2 + R + H (``renv_net`` and the colour head's
        second pass), 3 F3 + 3 S;
      * the frozen heads (D and H) take input gradients and no weight
        gradients: their backward counts once, so D + H less in pass 2 and
        D + 2 H less in pass 3.  (The program computes their weight
        gradients all the same, for the finite check; they are not
        counted.)
    Returns {"pass1", "pass2", "pass3", "S", "C", "D", "H", "R"}."""
    per = readers.flops_per_sample(o)
    g, env = o["geo_feat_dim"], o["env_feat_dim"]
    ide = (2 ** o["sh_degree"] - 1 + o["sh_degree"]) * 2
    S = per["encoder"] + per["sdf"]
    C = 2 * readers.mlp_flops([ide] + [o["hidden_dim_env"]] * (o["num_layers_env"] - 1) + [env])
    D = readers.mlp_flops([g + env] + [o["hidden_dim_diffuse"]] * (o["num_layers_diffuse"] - 1)
                          + [3])
    H = readers.mlp_flops([g + 3 + env + 1] + [o["hidden_dim_color"]]
                          * (o["num_layers_color"] - 1) + [3])
    R = readers.mlp_flops(RENV_DIMS + [env])
    F2 = S + C + D + H
    F3 = F2 + R + H
    return {"pass1": 6 * S, "pass2": 3 * F2 + 3 * S - (D + H),
            "pass3": 3 * F3 + 3 * S - (D + 2 * H), "S": S, "C": C, "D": D, "H": H, "R": R}


def mfu(run):
    """The step's model FLOPs over the window's time, in percent of the
    H100's 67 TFLOP/s float32 peak outside the tensor cores
    (``readers.PEAK_FLOPS``; the MLPs compute in float32 with TF32 off).
    Moves the cell's train rays/s.

    The window's pass-3 samples are ``num_rays`` x the ``mean_count`` each
    ``train_step`` returns; passes 1 and 2 are counted by their ratio to
    pass 3 in the traced steps' counters (``indirect.geometry.samples``,
    ``indirect.reflect.samples``, ``march.samples``).  Each pass's samples
    times its FLOPs a sample (:func:`step_flops`); the grid refresh is left
    out, as ``readers.mfu`` leaves it out."""
    if run.kind != "train" or run.window.wall_s <= 0 or run.window.samples <= 0:
        return None
    got = _counters(run, "indirect.geometry.samples", "indirect.reflect.samples",
                    "march.samples")
    if got is None or not got[2]:
        return None
    n1, n2, n3 = got
    f = step_flops(run.options)
    flops = run.window.samples * (f["pass3"] + n1 / n3 * f["pass1"] + n2 / n3 * f["pass2"])
    return 100.0 * flops / run.window.wall_s / readers.PEAK_FLOPS
