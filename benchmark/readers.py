"""The per-layer metrics' readers and their counts, shared by the files of
``metrics/``: a file there names one metric of ``BENCHMARK.json`` and binds
its ``read(run)`` to one of these.  Each returns a number, or None where the
run holds nothing to read."""

from benchmark.harness import median

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
KERNEL = "level_kernel"


def idle_share_train(run):
    """Share of the window's time in which the device ran nothing, in percent,
    for training: 1 minus the device's busy time a step over the window's wall
    time a step.  The busy time is the union of kernel, memcpy and memset
    intervals in the profiled steps after the window
    (``harness.reduce_trace``), over their count; the wall time a step is the
    untraced window's.  The profiler slows the host (its traced steps take up
    to twice as long), so the traced stretch's own idle share would measure
    the profiler; the device's work a step does not change under it.
    Moves the cell's train rays/s: an idle device waits for the host."""
    if run.kind != "train" or run.trace is None or run.trace.busy_s <= 0 or not run.trace_ks:
        return None
    busy = run.trace.busy_s / len(run.trace_ks)
    return 100.0 * (1.0 - busy / (run.window.wall_s / run.window.steps))


def grid_refresh_step_ms(run):
    """Median time of the window's grid-refresh steps, in ms: the CUDA-event
    interval from before a step that refreshes the occupancy grid to before the
    next step.  A median of pieces, so a per-layer metric; moves the cell's
    step p95 where it reports one (every 16th step carries the refresh), else
    its train rays/s."""
    if run.kind != "train" or not run.window.step_ms:
        return None
    ms = [t for t, r in zip(run.window.step_ms, run.window.refresh) if r]
    return median(ms) if ms else None


def trainer_host_ms(run):
    """Median host time of one ``Trainer.train_step`` call in the window, in
    ms: the trainer's Python and launch cost, and where the step syncs, its
    wait.  Moves the cell's train rays/s once the device outruns the host."""
    if run.kind != "train" or not run.window.host_ms:
        return None
    return median(run.window.host_ms)


def mlp_flops(dims):
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def encoder_flops(o) -> int:
    L, C = o["num_levels"], o["level_dim"]
    if o["encoding_pos"] == "cp":
        r = o["cp_rank"]
        return L * (3 * 3 * r + 2 * r + 2 * r * C)
    return L * (3 * 4 + 8 * 2 + 8 * 2 * C)


def flops_per_sample(o) -> dict:
    """{"encoder", "sdf", "color", "forward", "step"} FLOPs of one sample."""
    L, C, g, env = o["num_levels"], o["level_dim"], o["geo_feat_dim"], o["env_feat_dim"]
    ide = (2 ** o["sh_degree"] - 1 + o["sh_degree"]) * 2
    enc = encoder_flops(o)
    sdf = mlp_flops([L * C] + [o["hidden_dim"]] * (o["num_layers"] - 1) + [1 + g + 1])
    color = (2 * mlp_flops([ide] + [o["hidden_dim_env"]] * (o["num_layers_env"] - 1) + [env])
             + mlp_flops([g + env] + [o["hidden_dim_diffuse"]] * (o["num_layers_diffuse"] - 1)
                         + [3])
             + mlp_flops([g + 3 + env + 1] + [o["hidden_dim_color"]] * (o["num_layers_color"] - 1)
                         + [3]))
    fwd = enc + sdf + color
    return {"encoder": enc, "sdf": sdf, "color": color, "forward": fwd,
            "step": 3 * fwd + 3 * (enc + sdf)}


def mfu(run):
    """The train step's model FLOPs over the window's time, in percent of the
    H100's 67 TFLOP/s float32 peak outside the tensor cores (NVIDIA's data
    sheet, SXM, 700 W).  The MLPs compute in float32 with TF32 off, so that is
    the peak of the stated precision.  Moves the cell's train rays/s.

    FLOPs are counted per marched sample, over the samples these inputs need:
    ``num_rays`` x the ``mean_count`` each ``train_step`` returns, summed on the
    device and read once after the window (the program runs every one of the
    K slots of a ray, the valid or not; those are not counted).

    Per sample, a multiply-add is 2 FLOPs:
      * a linear layer in -> out: 2 * in * out (biases and activations left out);
      * the CP encoder, per level: three axis lerps of ``rank`` values (2
        products and a sum each: 3 * rank per axis), the product of the three
        (2 * rank) and the [rank, C] projection (2 * rank * C);
      * the tiled hash grid, per level: smoothstep weights (3 axes x 4), the 8
        corner weights (2 products each) and the 8 weighted rows (2 * C each);
      * the SDF net [L*C, hidden x (layers - 1), 1 + geo_feat + 1], the env net
        twice (the reflected direction's and the normal's IDE,
        [ide, hidden_env x (layers - 1), env_feat]), the diffuse net
        [geo + env, hidden_diffuse x (layers - 1), 3] and the colour net
        [geo + 3 + env + 1, hidden_color x (layers - 1), 3]; the IDE and the
        compositing are left out (a few hundred FLOPs);
      * the step: the forward F, twice F for the backward, and for the eikonal
        term the SDF branch's input gradient with ``create_graph`` (one forward
        S of encoder plus SDF net) and its backward (2 S): 3 F + 3 S.
    No recomputation: the program keeps its activations."""
    if run.kind != "train" or run.window.wall_s <= 0 or run.window.samples <= 0:
        return None
    flops = run.window.samples * flops_per_sample(run.options)["step"]
    return 100.0 * flops / run.window.wall_s / PEAK_FLOPS


def launch_bytes(L: int, B: int, W: int, S: int) -> int:
    return L * B * 4 + L * B * W * 4 + L * S * W * 4


def scatter_add_rows_roofline(run):
    """``scatter_add_rows``'s share of its bytes roofline on the hash path, in
    percent: the least time its traced launches could take over the device
    time they took.  Moves ``train_rays_per_s.hash``.

    The kernel (``csrc/scatter_rows.cu``) writes the table gradient of the
    tiled hash grid: ``[L, B]`` int32 indices and ``[L, B, W]`` f32 rows into a
    ``[L, S, W]`` f32 output.  Its bound reads each index and row once and
    writes the output once, ``L*B*4 + L*B*W*4 + L*S*W*4`` bytes, at 3.35 TB/s
    (the H100's HBM3, NVIDIA's data sheet).  W = 8 corners x ``level_dim``; S
    is the largest level, ``2^log2_hashmap_size``.

    B is what the step hands each launch: ``ops/hashgrid.py`` encodes the
    march's padded samples, ``num_rays`` x K of the step (the epoch's budget,
    ``train_step``'s ``K``), none compacted; a step makes two launches (the
    first-order table gradient, and the second-order one of the eikonal
    term).  Each launch is one ``cudaMemsetAsync`` of level 0 and L
    ``level_kernel`` launches (each zeroing the next level as it ends), so its
    time is the ``level_kernel`` intervals plus the memset that each launch's
    first one follows.  Without the expected 2 L kernels a step the reader
    returns nothing."""
    if run.kind != "train" or run.trace is None or not run.trace_ks:
        return None
    o = run.options
    L, W, S = o["num_levels"], 8 * o["level_dim"], 2 ** o["log2_hashmap_size"]
    ev = run.trace.device_events
    kernels = [i for i, e in enumerate(ev) if KERNEL in e[0]]
    if not kernels or len(kernels) != 2 * L * len(run.trace_ks):
        return None
    t = sum(ev[i][3] - ev[i][2] for i in kernels)
    for j in kernels[::L]:             # each launch's memset, just before its first level
        if j > 0 and ev[j - 1][1] == "gpu_memset":
            t += ev[j - 1][3] - ev[j - 1][2]
    bound = sum(2 * launch_bytes(L, o["num_rays"] * k, W, S) for k in run.trace_ks) / PEAK_BYTES
    return 100.0 * bound / (t * 1e-6)
