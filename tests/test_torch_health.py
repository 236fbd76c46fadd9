"""The port's health telemetry (``repro_torch.obs.health``), its taps in
``core/einet.py``, the health output of the training step and the
divergence flight recorder (``repro_torch.obs.incident``) on the CPU, case
for case the contracts of ``tests/test_health.py``, and the health vector
against the reference's ``health_vector`` on the same parameters and
batch.

Tolerances against the reference: counts and fractions exact; LL and
weight entropy rtol 1e-5; statistic norms rtol 1e-4 (sums over the batch
in other orders than XLA's).  ``leaf.clamp_frac`` is held exactly against
the reference's ``clamp_fraction`` of the port's own new parameters: a
variance pinned at its bound sits there up to rounding, so the side of
``<=`` it falls on differs between any two computations of the
parameters that round differently.  Step programs go through a registry with an
injected capture function that records nothing (a real capture executes
nothing) and replays by running the stage.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EiNet as RefEiNet
from repro.core import Normal as RefNormal
from repro.core import poon_domingos as ref_pd
from repro.core import random_binary_trees as ref_rbt
from repro.core import exponential_family as ref_ef
from repro.obs.check import validate_events, validate_metrics
from repro.train import TrainConfig as RefTrainConfig
from repro.train import make_em_step as ref_make_em_step
from repro_torch import compile as compile_lib
from repro_torch.convert import params_from_jax
from repro_torch.core import exponential_family as ef_lib
from repro_torch.core import poon_domingos, random_binary_trees
from repro_torch.core.einet import EiNet
from repro_torch.obs import health as health_lib
from repro_torch.train import TrainConfig, make_em_step
from repro_torch.train.pipeline import fit

EXACT = ("ll.nonfinite", "stat.nonfinite")  # counts; fractions end in _frac
RTOL = {"ll.mean": 1e-5, "ll.min": 1e-5, "weight.entropy": 1e-5,
        "stat.norm.max": 1e-4, "stat.norm.mean": 1e-4}


def _capture_nothing(run, device, pool):
    """A capture that records nothing and executes nothing; a replay runs
    the stage."""
    return run, None


def _registry():
    return compile_lib.ProgramRegistry(capture_fn=_capture_nothing)


def _rat_net(health=None, grouped=True):
    return EiNet(random_binary_trees(8, 2, 2, seed=0), num_sums=3,
                 health=health, grouped=grouped, device="cpu", seed=0)


def _x(d, b=16, seed=0):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(b, d).astype(np.float32))


def _params(net):
    return [p.detach().clone() for p in net.parameters()]


# ----------------------------------------------------------------- resolve
def test_resolve_health_env(monkeypatch):
    monkeypatch.delenv("REPRO_HEALTH", raising=False)
    assert health_lib.resolve_health(None) is False
    assert health_lib.resolve_health(True) is True
    monkeypatch.setenv("REPRO_HEALTH", "1")
    assert health_lib.resolve_health(None) is True
    assert health_lib.resolve_health(False) is False  # ctor wins
    assert _rat_net().health is True
    monkeypatch.setenv("REPRO_HEALTH", "off")
    assert health_lib.resolve_health(None) is False
    assert _rat_net().health is False


@pytest.mark.parametrize("structure", ["rat", "rat_per_layer", "pd"])
def test_spec_matches_plan(structure):
    if structure == "pd":
        net = EiNet(poon_domingos(4, 4, 2), num_sums=3, device="cpu")
        ref = RefEiNet(ref_pd(4, 4, 2), num_sums=3)
    else:
        grouped = structure == "rat"
        net = _rat_net(grouped=grouped)
        ref = RefEiNet(ref_rbt(8, 2, 2, seed=0), num_sums=3,
                       grouped=grouped)
    spec = net.health_spec
    assert spec.num_segments == len(net.walk_segments())
    assert spec.names == ref.health_spec.names
    assert spec.names[: len(health_lib.BASE_SLOTS)] == health_lib.BASE_SLOTS
    assert spec.index("ll.mean") == 0
    assert set(spec.to_dict(np.zeros(spec.size))) == set(spec.names)


# ------------------------------------------------ the step's health output
def test_health_on_one_program_a_shape():
    """3 health-on steps capture one program; the vector is one more
    output of it, float32, finite on a healthy batch."""
    net = _rat_net(health=True)
    reg = _registry()
    step = make_em_step(net, TrainConfig(), registry=reg)
    x = _x(net.num_vars)
    for _ in range(3):
        ll, hv = step(x)
    assert reg.stats["compiles"] == 1 and len(step.graphs) == 1
    assert hv.shape == (net.health_spec.size,) and hv.dtype == torch.float32
    vals = net.health_spec.to_dict(hv)
    assert np.isfinite(vals["ll.mean"]) and vals["ll.mean"] == pytest.approx(
        ll, rel=1e-6)
    assert vals["ll.nonfinite"] == 0 and vals["stat.nonfinite"] == 0
    assert 0.0 <= vals["seg0.sat_frac"] <= 1.0


def test_health_toggle_is_distinct_cached_program():
    net = _rat_net()
    reg = _registry()
    a = make_em_step(net, TrainConfig(health=True), registry=reg)
    b = make_em_step(net, TrainConfig(health=False), registry=reg)
    assert a is not b
    assert make_em_step(net, TrainConfig(health=True), registry=reg) is a
    assert reg.stats["hits"] == 1


@pytest.mark.parametrize("microbatches", [1, 4])
def test_health_off_bitwise_identical(microbatches):
    """Health on against off: the same parameters and LL bit for bit (the
    vector is computed, never fed back)."""
    on, off = _rat_net(), _rat_net()
    x = _x(on.num_vars, b=16)
    cfg = dict(num_microbatches=microbatches)
    ll_on, _ = make_em_step(on, TrainConfig(health=True, **cfg),
                            registry=_registry())(x)
    ll_off = make_em_step(off, TrainConfig(health=False, **cfg),
                          registry=_registry())(x)
    assert ll_on == ll_off
    for a, b in zip(on.parameters(), off.parameters()):
        assert torch.equal(a, b)


def test_tap_disabled_outside_collect():
    net = _rat_net()
    with torch.no_grad():
        net.log_likelihood(_x(net.num_vars))  # runs the tap sites
    with health_lib.collect() as taps:
        pass
    assert taps == []


@pytest.mark.parametrize("grouped", [True, False], ids=["planned", "layer"])
def test_pd_gather_taps(grouped):
    """Gather-topology walk: one tap per plan segment (per pair per layer),
    all finite, the gather run's over its new rows."""
    net = EiNet(poon_domingos(4, 8, 2), num_sums=3, health=True,
                grouped=grouped, device="cpu")
    x = _x(net.num_vars, b=8)
    with torch.no_grad():
        rows = net.leaf_rows(x, None)
        with health_lib.collect() as taps:
            net.forward_rows(rows)
    assert len(taps) == net.health_spec.num_segments
    assert all(np.isfinite(float(t)) for t in taps)
    if grouped:
        assert net.exec_plan[0].kind == "gather"


# ------------------------------------------------------ against the reference
def _ref_pair(structure):
    if structure == "pd":
        ref = RefEiNet(ref_pd(4, 8, 2), num_sums=4,
                       exponential_family=RefNormal(), health=True)
        port = EiNet(poon_domingos(4, 8, 2), num_sums=4, health=True,
                     device="cpu")
    else:
        ref = RefEiNet(ref_rbt(16, 2, 2, seed=0), num_sums=4,
                       exponential_family=RefNormal(), health=True)
        port = EiNet(random_binary_trees(16, 2, 2, seed=0), num_sums=4,
                     health=True, device="cpu")
    params = jax.jit(ref.init)(jax.random.PRNGKey(3))
    pnp = jax.tree_util.tree_map(np.asarray, params)
    port.load_state_dict(params_from_jax(pnp, port))
    return ref, params, port


@pytest.mark.parametrize("microbatches", [1, 4])
@pytest.mark.parametrize("structure", ["rat", "pd"])
def test_health_vector_matches_reference(structure, microbatches):
    ref, params, port = _ref_pair(structure)
    x = np.random.RandomState(4).randn(16, port.num_vars).astype(np.float32)
    x[3, :] = -40.0  # rows far in the tails
    _, _, want = ref_make_em_step(
        ref, RefTrainConfig(donate=False, num_microbatches=microbatches,
                            health=True))(params, jnp.asarray(x))
    _, got = make_em_step(port, TrainConfig(num_microbatches=microbatches,
                                            health=True))(torch.from_numpy(x))
    spec = port.health_spec
    assert spec.names == ref.health_spec.names
    got, want = spec.to_dict(got), spec.to_dict(np.asarray(want))
    clamp = float(ref.ef.clamp_fraction(jnp.asarray(port.phi.detach().numpy())))
    assert got.pop("leaf.clamp_frac") == clamp and clamp > 0
    for name in got:
        if name in RTOL:
            np.testing.assert_allclose(got[name], want[name], rtol=RTOL[name],
                                       err_msg=name)
        else:
            assert name in EXACT or name.endswith("_frac")
            assert got[name] == want[name], name


# --------------------------------------------------- the flight recorder
def _nan_batches(net, n=6, nan_from=3):
    out = []
    for i in range(n):
        x = np.random.RandomState(i).randn(16, net.num_vars).astype(
            np.float32)
        if i >= nan_from:
            x[0, 0] = np.nan
        out.append(x)
    return out


def test_incident_bundle_once_and_schema(tmp_path):
    """A NaN row under "continue": training survives, exactly one bundle
    with its six files, each valid under the reference's schema checks."""
    net = _rat_net(health=True)
    policy = health_lib.HealthPolicy(
        on_incident="continue", incident_dir=str(tmp_path / "incidents"))
    lls = fit(net, _nan_batches(net), TrainConfig(), health_policy=policy,
              registry=_registry())
    assert len(lls) == 6
    root = tmp_path / "incidents"
    bundles = sorted(os.listdir(root))
    assert len(bundles) == 1
    bundle = root / bundles[0]
    assert sorted(os.listdir(bundle)) == sorted([
        "incident.json", "metrics.json", "trace.json", "health_history.json",
        "params.npz", "params_tree.txt"])
    with open(bundle / "incident.json") as f:
        inc = json.load(f)
    assert inc["step"] == 3 and "non-finite" in inc["reason"]
    assert inc["health_slots"] == list(net.health_spec.names)
    with open(bundle / "trace.json") as f:
        trace = json.load(f)
    assert validate_events(trace) == []
    assert any(ev["name"] == "train.incident" for ev in trace["traceEvents"])
    with open(bundle / "metrics.json") as f:
        snap = json.load(f)
    assert all("'train.health." in p or "'train.ll." in p
               for p in validate_metrics(snap))
    assert any(k.startswith("train.health.") for k in snap)
    with open(bundle / "health_history.json") as f:
        assert json.load(f)[-1]["step"] == 3
    with np.load(bundle / "params.npz") as npz:
        assert len(npz.files) == len(list(net.parameters()))
    with open(bundle / "params_tree.txt") as f:
        assert f.read().startswith(
            "PyTreeDef({'class_prior': *, 'einsum': [*, *], 'mixing': [*, *]")


def test_abort_policy_raises(tmp_path):
    net = _rat_net(health=True)
    policy = health_lib.HealthPolicy(
        on_incident="abort", incident_dir=str(tmp_path / "incidents"))
    with pytest.raises(health_lib.DivergenceError, match="non-finite"):
        fit(net, _nan_batches(net), TrainConfig(), health_policy=policy,
            registry=_registry())
    assert len(os.listdir(tmp_path / "incidents")) == 1


def test_watcher_relative_triggers():
    net = _rat_net()
    spec = net.health_spec
    policy = health_lib.HealthPolicy(on_incident="continue", max_incidents=0)
    w = health_lib.HealthWatcher(net, policy)
    base = {n: 0.0 for n in spec.names}
    base.update({"ll.mean": -10.0, "stat.norm.max": 1.0,
                 "stat.norm.mean": 1.0, "weight.entropy": 1.0})

    def vec(**over):
        d = dict(base, **over)
        return torch.tensor([d[n] for n in spec.names], dtype=torch.float32)

    for i in range(4):
        assert w.observe(i, vec()) is None
    assert w._check(dict(base, **{"stat.norm.max": 100.0})) is not None
    assert w._check(dict(base, **{"seg0.sat_frac": 0.9})) is not None
    assert w._check(dict(base)) is None
    with pytest.raises(ValueError, match="on_incident"):
        health_lib.HealthWatcher(net, health_lib.HealthPolicy(
            on_incident="ignore"))


def test_ef_clamp_fraction_families():
    n = ef_lib.Normal(min_var=1e-6, max_var=10.0)
    phi = torch.zeros((4, 1, 1, 2))
    phi[..., 1] = 1.0
    phi[0, ..., 1] = 0.0
    assert float(n.clamp_fraction(phi)) == pytest.approx(0.25)
    b = ef_lib.Bernoulli()
    pb = torch.full((4, 1, 1, 1), 0.5)
    pb[0] = 0.0
    assert float(b.clamp_fraction(pb)) == pytest.approx(0.25)
    bi = ef_lib.Binomial(n_trials=255)
    pbi = torch.full((4, 1, 1, 1), 128.0)
    pbi[0] = 0.0
    assert float(bi.clamp_fraction(pbi)) == pytest.approx(0.25)
    c = ef_lib.Categorical(num_categories=4)
    pc = torch.full((2, 1, 1, 4), 0.25)
    pc[0, ..., 0] = 0.0
    assert float(c.clamp_fraction(pc)) == pytest.approx(0.125)
    assert float(ef_lib.ExponentialFamily().clamp_fraction(pc)) == 0.0


@pytest.mark.parametrize("family", ["normal", "bernoulli", "binomial",
                                    "categorical"])
def test_clamp_fraction_matches_reference(family):
    """Every family on random parameters with some pinned at their bounds:
    the same fraction as the reference's, exactly."""
    kw = {"binomial": dict(n_trials=255),
          "categorical": dict(num_categories=4)}.get(family, {})
    port = ef_lib.make_exponential_family(family, **kw)
    ref = ref_ef.make_exponential_family(family, **kw)
    rng = np.random.RandomState(0)
    shape = (6, 3, 2, port.num_stats)
    if family == "normal":
        mu = rng.randn(*shape[:-1])
        var = np.exp(rng.uniform(-16, 3, shape[:-1]))
        var.flat[::5] = 1e-7
        phi = np.stack([mu, mu * mu + var], -1)
    else:
        scale = 255.0 if family == "binomial" else 1.0
        phi = rng.uniform(0, 1, shape) * scale
        phi.flat[::4] = 0.0
        phi.flat[1::7] = scale
    phi = phi.astype(np.float32)
    got = float(port.clamp_fraction(torch.from_numpy(phi)))
    want = float(ref.clamp_fraction(jnp.asarray(phi)))
    assert got == want and got > 0
