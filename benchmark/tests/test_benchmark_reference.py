"""The reference against the program on the CPU at a tiny size, and the
TF32 and half-batch controls, put in the program's place, coming out not
correct at the limits the cells hold."""

import pytest
import torch

from cpu_cells import SEED, find, tiny_options

TRAIN = ["cp_train", "hash_train"]


def judged(name, seed, variant):
    """A variant's readings on the CPU at the tiny size, judged against the
    cell's committed limits as the benchmark's runs judge the program."""
    from benchmark.control import judged as judge
    torch.set_num_threads(2)
    cell = find(name)
    return cell, judge(cell, seed, torch.device("cpu"), tiny_options(cell), 40, variant)


@pytest.mark.parametrize("name", TRAIN)
def test_reference_follows_the_program(name):
    """The program is correct at the committed limits, and on every number
    compared lies ten times or more closer to the reference than the
    reference at TF32 does, on the same seed at the same size."""
    cell, got = judged(name, SEED, "program")
    assert got["correct"], got["checks"]
    _, tf32 = judged(name, SEED, "tf32")
    for k in cell.params["limits"]:
        assert got[k] <= tf32[k] / 10, (k, got[k], tf32[k])


@pytest.mark.parametrize("name", TRAIN)
def test_tf32_control_fails(name):
    _, got = judged(name, SEED + 1, "tf32")
    assert not got["correct"], got["checks"]


@pytest.mark.parametrize("name", TRAIN)
def test_half_batch_control_fails(name):
    _, got = judged(name, SEED + 2, "half_batch")
    assert not got["correct"], got["checks"]


def test_tf32_rounding():
    from benchmark.reference.model import round_tf32
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.14159265], requires_grad=True)
    y = round_tf32(x)
    assert y.tolist()[:3] == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10]
    assert abs(y[3].item() - 3.14159265) < 2 ** -9
    (g,) = torch.autograd.grad(y.sum(), x)
    assert g.tolist() == [1.0, 1.0, 1.0, 1.0]


def test_initial_weights_follow_their_laws():
    from benchmark.reference import model, params
    cell = find("hash_train")
    spec = model.Spec({**tiny_options(cell), **cell.config["stated"]})
    w = params.make(spec, 5, "cpu")
    assert set(w) == {n for n, *_ in params.leaves(spec)}
    assert w["encoder.embeddings"].abs().max() <= 1e-4
    assert float(w["sdf_density.beta"]) == pytest.approx(0.1)
    assert torch.all(w["color_net.2.bias"] == -torch.log(torch.tensor(3.0)))
    again = params.make(spec, 5, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)


def test_resumed_start_draws_only_the_nets_the_checkpoint_lacks():
    """cp_train resumes the CP checkpoint, trained with a 64-wide env net on
    IDE degree 4: the env net, at the configuration's 256 on degree 5, comes
    whole from the seed; every other leaf and the grid are the file's."""
    import os
    from benchmark import harness
    from benchmark.reference import ckpt, model
    cell = find("cp_train")
    kind = harness.load_module(os.path.join(harness.HERE, "traffic", "train.py"), "traffic_train")
    spec = model.Spec({**cell.options(), **cell.config["stated"]})
    start = kind.make_start(cell, spec, SEED, torch.device("cpu"))
    assert start.resumed and start.drawn == ["env_net"]
    raw = ckpt.read(os.path.join(harness.ROOT, cell.params["checkpoint"]))
    flat = ckpt.flat_params(raw["params"])
    assert tuple(start.params["env_net.0.weight"].shape) == (256, 72)
    assert tuple(flat["env_net.0.weight"].shape) == (64, 38)
    for k, v in start.params.items():
        if not k.startswith("env_net."):
            assert torch.equal(v, torch.from_numpy(flat[k])), k
    assert torch.equal(start.ema["env_net.1.weight"], start.params["env_net.1.weight"])
    assert start.iter_density >= 16 and start.global_step == int(raw["global_step"])
