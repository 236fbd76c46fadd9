"""The port's autodiff EM on the CPU against the JAX reference
(``repro.core.em``), with the same parameters carried across as numpy.

Tolerance for statistics and parameters: rtol 1e-4, atol 1e-5.  The port
sums in other orders than XLA (the reference's own Pallas-interpret path is
off its XLA path by up to 7.6e-6), so the comparison is with the
reference's XLA path and scaled to magnitude, never bitwise.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EiNet as RefEiNet
from repro.core import Normal as RefNormal
from repro.core import em as ref_em
from repro.core import poon_domingos as ref_pd
from repro.core import random_binary_trees as ref_rbt
from repro.data.synthetic import gaussian_mixture_images as ref_images
from repro_torch import compile as compile_lib
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import em, poon_domingos, random_binary_trees
from repro_torch.core.einet import EiNet
from repro_torch.data import gaussian_mixture_images
from repro_torch.kernels import ops
from repro_torch.launch.train import (
    batch_at,
    synthetic_pd_data,
    synthetic_rat_data,
)
from repro_torch.train import (
    TrainConfig,
    em_update_microbatched,
    fit,
    make_em_step,
    microbatched_em_statistics,
    stochastic_em_update_microbatched,
)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-5)
NV, DEPTH, REPS, K, B = 16, 2, 2, 4, 13


def _port(grouped=True, seed=0):
    return EiNet(random_binary_trees(NV, DEPTH, REPS, seed=0), num_sums=K,
                 grouped=grouped, device="cpu", seed=seed)


@pytest.fixture(scope="module")
def small():
    ref = RefEiNet(ref_rbt(NV, DEPTH, REPS, seed=0), num_sums=K,
                   exponential_family=RefNormal())
    params = jax.jit(ref.init)(jax.random.PRNGKey(2))
    pnp = jax.tree_util.tree_map(np.asarray, params)
    x = np.random.RandomState(1).randn(B, NV).astype(np.float32)
    return ref, params, pnp, x


def _load(pnp, grouped=True):
    port = _port(grouped)
    port.load_state_dict(params_from_jax(pnp, port))
    return port


def _close_trees(got, want, what):
    got_l = jax.tree_util.tree_leaves(got)
    want_l = jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l), what
    for a, b in zip(got_l, want_l):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=what,
                                   **TOL)


@pytest.mark.parametrize("grouped", [True, False], ids=["fused", "per_layer"])
def test_em_statistics_match_reference(small, grouped):
    ref, params, pnp, x = small
    port = _load(pnp, grouped)
    assert port.grouped_active == grouped
    got = em.em_statistics(port, torch.from_numpy(x))
    want = ref_em.em_statistics(ref, params, jnp.asarray(x))
    for key in ("n_einsum", "n_mixing", "s_phi", "s_den", "n_class", "ll",
                "count"):
        _close_trees(got[key], want[key], key)
    # a pair without mixing has an empty statistic, not None
    assert any(v.shape[0] == 0 for v in got["n_mixing"])


def test_em_update_matches_reference(small):
    ref, params, pnp, x = small
    port = _load(pnp)
    new, ll = em.em_update(port, torch.from_numpy(x))
    want, want_ll = ref_em.em_update(ref, params, jnp.asarray(x))
    _close_trees(new, want, "params")
    np.testing.assert_allclose(float(ll), float(want_ll), **TOL)
    blended, ll = em.stochastic_em_update(port, torch.from_numpy(x))
    want, want_ll = ref_em.stochastic_em_update(ref, params, jnp.asarray(x))
    _close_trees(blended, want, "blended params")
    np.testing.assert_allclose(float(ll), float(want_ll), **TOL)
    # the module is unchanged until the step loads the new parameters
    _close_trees(params_to_numpy(port), pnp, "unchanged")


def test_stochastic_em_steps_match_reference(small):
    ref, params, pnp, x = small
    port = _load(pnp)
    step = make_em_step(port, TrainConfig(mode="stochastic"))
    rng = np.random.RandomState(7)
    for i in range(3):
        xb = rng.randn(B, NV).astype(np.float32)
        ll = step(torch.from_numpy(xb))
        params, want_ll = ref_em.stochastic_em_update(ref, params,
                                                      jnp.asarray(xb))
        np.testing.assert_allclose(ll, float(want_ll), err_msg=f"step {i}",
                                   **TOL)
        _close_trees(params_to_numpy(port), params, f"step {i}")


def test_grouped_and_per_layer_e_steps_agree(small):
    _, _, pnp, x = small
    xt = torch.from_numpy(x)
    a = em.em_statistics(_load(pnp, True), xt)
    b = em.em_statistics(_load(pnp, False), xt)
    _close_trees(a, b, "grouped vs per-layer")


def test_microbatched_statistics_sum_the_pieces(small):
    _, _, pnp, x = small
    port = _load(pnp)
    xt = torch.from_numpy(np.concatenate([x[:12]] * 2))
    whole = microbatched_em_statistics(port, xt, 1)
    split = microbatched_em_statistics(port, xt, 4)
    _close_trees(split, whole, "microbatches")
    with pytest.raises(ValueError, match="divisible"):
        microbatched_em_statistics(port, xt, 5)


def test_full_em_does_not_lower_the_batch_ll():
    port = _port(seed=3)
    x = torch.from_numpy(np.random.RandomState(4).randn(64, NV)
                         .astype(np.float32))
    lls = fit(port, [x] * 4, TrainConfig(mode="full"))
    for a, b in zip(lls, lls[1:]):
        assert b >= a - 1e-5 * abs(a), lls
    assert lls[-1] > lls[0]


def test_em_step_updates_the_module_in_place():
    port = _port()
    before = [p.detach().clone() for p in port.parameters()]
    ids = [id(p) for p in port.parameters()]
    ops.reset_counts()
    make_em_step(port)(torch.from_numpy(synthetic_rat_data(NV)[:8]))
    assert [id(p) for p in port.parameters()] == ids
    assert any(not torch.equal(a, b) for a, b in zip(before, port.parameters()))
    # the E-step went through the fused op and its backward, plain on the CPU
    assert ops.grouped_log_einsum_exp.plain_calls == 1
    assert ops.grouped_log_einsum_exp_bwd.plain_calls == 1
    with pytest.raises(ValueError, match="mode"):
        make_em_step(port, TrainConfig(mode="adam"))


def test_synthetic_data_is_the_reference_stream():
    data = synthetic_rat_data(12)
    np.testing.assert_array_equal(
        data, np.random.RandomState(0).randn(4096, 12).astype(np.float32))
    t = torch.from_numpy(data)
    assert torch.equal(batch_at(t, 1, 3000)[:1096], t[3000:])
    assert torch.equal(batch_at(t, 1, 3000)[1096:], t[:1904])


# a Poon-Domingos structure: one gather run [0, 3) with interior mixing,
# then the root pair per layer
PD_SHAPE = (4, 8, 2)


@pytest.fixture(scope="module")
def pd_small():
    ref = RefEiNet(ref_pd(*PD_SHAPE), num_sums=K,
                   exponential_family=RefNormal())
    params = jax.jit(ref.init)(jax.random.PRNGKey(5))
    pnp = jax.tree_util.tree_map(np.asarray, params)
    x = np.random.RandomState(3).randn(B, 32).astype(np.float32)
    return ref, params, pnp, x


def _load_pd(pnp, grouped=True):
    port = EiNet(poon_domingos(*PD_SHAPE), num_sums=K, grouped=grouped,
                 device="cpu")
    port.load_state_dict(params_from_jax(pnp, port))
    return port


def test_pd_em_update_matches_reference(pd_small):
    ref, params, pnp, x = pd_small
    port = _load_pd(pnp)
    assert [s.kind for s in port.exec_plan] == ["gather", "layer"]
    new, ll = em.em_update(port, torch.from_numpy(x))
    want, want_ll = ref_em.em_update(ref, params, jnp.asarray(x))
    _close_trees(new, want, "params")
    np.testing.assert_allclose(float(ll), float(want_ll), **TOL)


def test_pd_stochastic_em_steps_match_reference(pd_small):
    ref, params, pnp, _ = pd_small
    port = _load_pd(pnp)
    step = make_em_step(port, TrainConfig(mode="stochastic"))
    rng = np.random.RandomState(8)
    for i in range(3):
        xb = rng.randn(B, 32).astype(np.float32)
        ll = step(torch.from_numpy(xb))
        params, want_ll = ref_em.stochastic_em_update(ref, params,
                                                      jnp.asarray(xb))
        np.testing.assert_allclose(ll, float(want_ll), err_msg=f"step {i}",
                                   **TOL)
        _close_trees(params_to_numpy(port), params, f"step {i}")


def test_pd_e_step_takes_mixing_statistics_from_the_gather_backward(pd_small):
    """The gather run's mixing weights get their gradients from the gather
    backward's gV, the root pair's from the mixing layer's own backward;
    the planned E-step agrees with the per-layer one and the reference."""
    ref, params, pnp, x = pd_small
    port = _load_pd(pnp)
    ops.reset_counts()
    got = em.em_statistics(port, torch.from_numpy(x))
    assert (ops.gather_grouped_log_einsum_exp.plain_calls,
            ops.gather_grouped_log_einsum_exp_bwd.plain_calls,
            ops.log_einsum_exp_bwd.plain_calls) == (1, 1, 1)
    mixed = [i for i, sp in enumerate(port.pair_specs)
             if sp.mix_global is not None]
    assert mixed[-1] == len(port.pair_specs) - 1 and len(mixed) >= 2
    assert all(float(got["n_mixing"][i].abs().max()) > 0 for i in mixed)
    want = ref_em.em_statistics(ref, params, jnp.asarray(x))
    _close_trees(got["n_mixing"], want["n_mixing"], "n_mixing")
    _close_trees(got["n_einsum"], want["n_einsum"], "n_einsum")
    per_layer = em.em_statistics(_load_pd(pnp, grouped=False),
                                 torch.from_numpy(x))
    _close_trees(got, per_layer, "planned vs per-layer")


def test_synthetic_pd_data_is_the_reference_stream():
    np.testing.assert_array_equal(
        gaussian_mixture_images(64, 8, 5, 2, num_components=3, seed=4),
        ref_images(64, 8, 5, 2, num_components=3, seed=4))
    data = synthetic_pd_data(100)
    assert data.shape == (4096, 100) and data.dtype == np.float32
    np.testing.assert_array_equal(
        data, ref_images(4096, 16, 3, 3, seed=0)[:, :100])


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        env=env, capture_output=True, text=True, timeout=300)


def test_train_cli_on_cpu():
    out = _cli("--arch", "einet_rat", "--steps", "3", "--batch", "64",
               "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "ms/step" in out.stdout and "fused" in out.stdout
    assert "allow_tf32=False" in out.stdout
    assert "grouped_log_einsum_exp_bwd 0 (1)" in out.stdout


def test_train_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    out = _cli("--arch", "einet_rat", "--steps", "1")
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr


def test_train_cli_pd_on_cpu():
    out = _cli("--arch", "einet_pd", "--steps", "2", "--batch", "16",
               "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "'gather'" in out.stdout and "ms/step" in out.stdout
    assert "gather_grouped_log_einsum_exp_bwd 0 (1)" in out.stdout


# ----------------------------------------------------------- step programs
# A registry whose capture function records nothing and executes nothing
# (as a real capture executes nothing); a replay runs the stage, counted.
class _Seam:
    def __init__(self):
        self.captures = 0
        self.replays = 0

    def __call__(self, run, device, pool):
        self.captures += 1

        def replay():
            self.replays += 1
            run()

        return replay, None


def _seam_registry():
    seam = _Seam()
    return compile_lib.ProgramRegistry(capture_fn=seam), seam


def _batches(n, b=16, seed=5):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, NV).astype(np.float32))
            for _ in range(n)]


def _eager_steps(port, xs, mb=1, mode="stochastic"):
    update = (stochastic_em_update_microbatched if mode == "stochastic"
              else em_update_microbatched)
    lls = []
    for x in xs:
        new, ll = update(port, x, em.EMConfig(), mb)
        em.load_params(port, new)
        lls.append(float(ll))
    return lls


def _same(a, b):
    return all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))


def test_step_program_is_cached_per_model_and_config():
    reg, _ = _seam_registry()
    a, b = _port(), _port()
    s1 = make_em_step(a, TrainConfig(), registry=reg)
    assert make_em_step(a, TrainConfig(), registry=reg) is s1
    assert make_em_step(a, TrainConfig(mode="full"), registry=reg) is not s1
    assert make_em_step(a, TrainConfig(health=True), registry=reg) is not s1
    assert make_em_step(b, TrainConfig(), registry=reg) is not s1
    assert isinstance(s1, compile_lib.StepProgram)
    # the default registry makes a CPU model's step an op-by-op program
    eager = make_em_step(a)
    assert isinstance(eager, compile_lib.EagerStepProgram)
    assert make_em_step(a) is eager


@pytest.mark.parametrize("mode", ["stochastic", "full"])
def test_first_graph_call_is_one_eager_step(mode):
    """The warm-up runs the step for real and then puts the parameters
    back, so the first call is exactly one step."""
    reg, seam = _seam_registry()
    g, e = _port(), _port()
    x = _batches(1)[0]
    ll = make_em_step(g, TrainConfig(mode=mode), registry=reg)(x)
    assert seam.captures == 1 and seam.replays == 1
    assert [ll] == _eager_steps(e, [x], mode=mode)
    assert _same(g, e)


@pytest.mark.parametrize("grouped", [True, False], ids=["fused", "per_layer"])
def test_microbatch_body_replays_equal_the_eager_loop(grouped):
    """Four microbatches: the body graph replayed four times a step into
    the static accumulators, then the finish graph, bit for bit the eager
    microbatch loop (update, then load_params), step after step."""
    reg, seam = _seam_registry()
    g, e = _port(grouped), _port(grouped)
    step = make_em_step(g, TrainConfig(num_microbatches=4), registry=reg)
    xs = _batches(3)
    lls = [step(x) for x in xs]
    assert seam.captures == 2  # the body graph and the finish graph
    assert seam.replays == 3 * (4 + 1)
    assert lls == _eager_steps(e, xs, mb=4)
    assert _same(g, e)
    with pytest.raises(ValueError, match="divisible"):
        step(_batches(1, b=10)[0])


def test_recapture_only_when_a_tensor_moves(tmp_path):
    """Writing parameters in place (``load_params``, a restored checkpoint)
    recaptures nothing; a replaced parameter tensor recaptures its shape's
    graphs once; a new batch shape captures its own."""
    from repro_torch.checkpoint import CheckpointManager

    reg, _ = _seam_registry()
    g, e = _port(), _port()
    step = make_em_step(g, TrainConfig(), registry=reg)
    xs = _batches(4)
    step(xs[0])
    snap = {k: (v.clone() if torch.is_tensor(v) else [t.clone() for t in v])
            for k, v in em.params_of(g).items()}
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, {"params": em.params_of(g)})
    step(xs[1])
    em.load_params(g, snap)
    step(xs[1])
    _eager_steps(e, [xs[0], xs[1]])
    assert _same(g, e)  # the step after load_params ran on its parameters
    step(xs[2])
    _, back = mgr.restore({"params": em.params_of(g)})
    em.load_params(g, back["params"])
    step(xs[1])
    assert _same(g, e)  # and after a restored checkpoint
    assert reg.stats["compiles"] == 1
    with torch.no_grad():
        g.class_prior = torch.nn.Parameter(g.class_prior.detach().clone())
    step(xs[2])
    assert reg.stats["compiles"] == 2
    step(xs[3][:8])
    assert reg.stats["compiles"] == 3 and len(step.graphs) == 2


def test_step_program_releases_its_model():
    """The stages hold no reference to the model: a dead model's step
    program leaves the registry."""
    import gc

    reg, _ = _seam_registry()
    port = _port()
    step = make_em_step(port, TrainConfig(num_microbatches=2), registry=reg)
    step(_batches(1)[0])
    assert reg.num_programs() == 1
    del port, step
    gc.collect()
    assert reg.num_programs() == 0


def test_fit_runs_the_step_program():
    reg, seam = _seam_registry()
    g, e = _port(), _port()
    xs = _batches(3)
    lls = fit(g, xs, TrainConfig(), registry=reg)
    assert seam.captures == 1 and seam.replays == 3
    assert lls == _eager_steps(e, xs)
    assert _same(g, e)


def test_train_cli_smoke_checkpoints_and_resumes(tmp_path):
    """``--smoke --device cpu``: health on, checkpoints every 4 steps under
    the tmp root; a second run with more steps resumes at the saved step."""
    ck = str(tmp_path / "ck")
    out = _cli("--smoke", "--device", "cpu", "--ckpt-dir", ck,
               "--checkpoint-every", "4", "--metrics",
               str(tmp_path / "m.json"))
    assert out.returncode == 0, out.stderr
    assert "health on" in out.stdout and "restarts=0" in out.stdout
    assert "objective: first" in out.stdout
    assert "resumed at step 0, committed steps [4, 8]" in out.stdout
    with open(tmp_path / "m.json") as f:
        assert "train.health.ll.mean" in f.read()
    again = _cli("--smoke", "--device", "cpu", "--ckpt-dir", ck,
                 "--checkpoint-every", "4", "--steps", "12")
    assert again.returncode == 0, again.stderr
    assert "resumed at step 8, committed steps [4, 8, 12]" in again.stdout
    assert "4 steps: median" in again.stdout
