"""The paper's benches in the port (``repro_torch.bench``) on the CPU:
Table 1 and Fig. 4 against the reference's ``benchmarks/bench_table1.py``
and ``bench_fig4.py`` from the same initial parameters (carried across as
numpy), Fig. 3 and Fig. 6 for their rows and their out-of-memory rule (their
figures are times, which no CPU run can hold against anything), and the
harness's CLI.

Tolerances: LLs rtol 1e-5, atol 1e-4 before training; after EM, whose
statistics sum in another order, rtol 1e-4; the mean-fill MSE (the same
data) rtol 1e-6; the argmax inpainting MSE from the same parameters rtol
1e-6 (the decode is identical).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import bench_fig4, bench_table1
from repro.core import Bernoulli as RefBernoulli
from repro.core import EiNet as RefEiNet
from repro.core import Normal as RefNormal
from repro.core import poon_domingos as ref_pd
from repro.core import random_binary_trees as ref_rbt
from repro_torch.bench import fig3, fig4, fig6, table1
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import NaiveEiNet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = (("nltcs", 16), ("msnbc", 17))


def _loader(make_ref):
    """A ``load`` hook writing the reference's seed-0 initialisation of
    ``make_ref(net)`` into the port's net."""
    def load(net):
        params = make_ref(net).init(jax.random.PRNGKey(0))
        net.load_state_dict(params_from_jax(
            jax.tree_util.tree_map(np.asarray, params), net))
    return load


def _table1_ref(net):
    d = net.num_vars
    return RefEiNet(ref_rbt(d, min(3, int(np.log2(d))), 4, seed=0),
                    num_sums=8, exponential_family=RefBernoulli())


def _fig4_ref(side, k):
    g = ref_pd(side, side, delta=max(2, side // 4), num_channels=3,
               axes=("w",))
    return RefEiNet(g, num_sums=k,
                    exponential_family=RefNormal(min_var=1e-6, max_var=1e-2))


def test_table1_matches_reference_bench(monkeypatch):
    for mod in (bench_table1, table1):
        monkeypatch.setattr(mod, "N_TRAIN", 64)
        monkeypatch.setattr(mod, "N_TEST", 32)
    monkeypatch.setattr(bench_table1, "TWENTY_DATASETS", TINY)
    want = bench_table1.run(quick=True)
    got = table1.run(quick=True, device="cpu", datasets=TINY,
                     load=_loader(_table1_ref))
    assert [r[:2] for r in got] == [r[:2] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[2:4], w[2:4], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(g[5], w[5], rtol=1e-4)
        assert g[4] < 1e-3 and w[4] < 1e-3
    assert table1.gate(got)


def test_table1_gate_and_profiles():
    rows = [("a", 4, -5.0, -5.0, 2e-3, -4.0)]
    assert not table1.gate(rows)
    assert not table1.gate([("a", 4, -5.0, -5.0, 0.0, -6.0)])
    assert table1.gate([("a", 4, -5.0, -5.0, 0.0, -4.0)])
    got = table1.run(quick=True, device="cpu", datasets=TINY[:1], epochs=1)
    assert got[0][:2] == ("nltcs", 16) and table1.gate(got)


def test_fig4_matches_reference_bench(tmp_path):
    sz = fig4.SIZES[True]
    side, k = sz["side"], sz["k"]
    load = _loader(lambda net: _fig4_ref(side, k))
    want = bench_fig4.run(quick=True, out_dir=str(tmp_path / "ref"))
    got = fig4.run(quick=True, device="cpu", out_dir=str(tmp_path / "port"),
                   load=load)
    np.testing.assert_allclose(got["ll_first_epoch"], want["ll_first_epoch"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["ll_last_epoch"], want["ll_last_epoch"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["meanfill_mse"], want["meanfill_mse"],
                               rtol=1e-6)
    assert fig4.gate(got) and got["samples_finite"]
    for name in ("samples", "inpainted", "originals"):
        arr = np.load(tmp_path / "port" / f"{name}.npy")
        assert arr.shape == (16, side, side, 3) and np.isfinite(arr).all()


def test_fig4_argmax_mse_from_the_same_parameters():
    """The port's trained parameters carried into the reference: its
    argmax decode and MSE (``bench_fig4``'s lines) equal the port's."""
    sz = fig4.SIZES[True]
    side, k = sz["side"], 4
    data = fig4.gaussian_mixture_images(256 + 16, side, side, 3, seed=0)
    train, test = data[:256], data[256:]
    net = fig4.build(side, k, torch.device("cpu"))
    fig4.train(net, train, 1)
    got = fig4.inpaint_mse(net, test, train.mean(0), side)
    ref = _fig4_ref(side, k)
    params = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(net))
    mask = jnp.asarray(fig4.left_half_mask(16, side))
    recon = np.asarray(ref.conditional_sample(
        params, jax.random.PRNGKey(3), jnp.asarray(test), mask,
        mode="argmax"))
    m = ~np.asarray(mask)
    want = float(np.mean((recon - test)[m] ** 2))
    np.testing.assert_allclose(got["inpaint_mse"], want, rtol=1e-6)


@pytest.fixture
def tiny_profile(monkeypatch):
    monkeypatch.setitem(fig3.PROFILES, "quick", dict(
        n=32, dvars=16, defaults=dict(depth=2, reps=2, k=3),
        sweeps={"K": [2, 3], "D": [1], "R": [1]}))


def test_fig3_rows_on_the_cpu(tiny_profile):
    rows = fig3.run(quick=True, device="cpu")
    assert [r[:3] for r in rows] == [
        (impl, p, v) for impl in ("einet", "naive")
        for p, v in (("K", 2), ("K", 3), ("D", 1), ("R", 1))]
    for r in rows:
        assert r[3] > 0 and r[5] > 0
        assert r[4] is None and r[6] is None  # no device memory off the card
    assert fig3.first_oom(rows) is None
    assert fig3.ratios(rows)["K"] == 3
    assert fig3.format_row(rows[0]).count(",") == fig3.HEADER.count(",")


def _oom_at_3(measure, naive_only):
    def fake(net, x):
        if net.K == 3 and (isinstance(net, NaiveEiNet) or not naive_only):
            raise torch.cuda.OutOfMemoryError("out of memory")
        return measure(net, x)
    return fake


@pytest.mark.parametrize("mod", [fig3, fig6], ids=["fig3", "fig6"])
def test_a_naive_oom_is_a_row_and_an_einet_one_raises(tiny_profile,
                                                      monkeypatch, mod):
    real = mod.measure
    monkeypatch.setattr(mod, "measure", _oom_at_3(real, naive_only=True))
    rows = mod.run(quick=True, device="cpu", sweeps={"K": [2, 3]})
    naive = [r for r in rows if r[0] == "naive"]
    assert all(v == fig3.OOM for v in naive[1][3:])
    assert all(v != fig3.OOM for r in rows if r is not naive[1]
               for v in r[3:])
    assert fig3.first_oom(rows) == 3
    monkeypatch.setattr(mod, "measure", _oom_at_3(real, naive_only=False))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        mod.run(quick=True, device="cpu", sweeps={"K": [2, 3]})


def test_fig6_rows_on_the_cpu(tiny_profile):
    rows = fig6.run(quick=True, device="cpu", sweeps={"K": [2, 3]})
    assert [r[:3] for r in rows] == [(i, "K", v) for i in ("einet", "naive")
                                     for v in (2, 3)]
    assert all(r[3] > 0 and r[4] > 0 for r in rows)
    assert fig6.format_row(rows[0]).count(",") == fig6.HEADER.count(",")


def test_bench_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.run", "--only", "table1",
         "--device", "cpu"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr
    assert table1.HEADER in out.stdout and "all-ok=True" in out.stdout
    assert '"bench": "table1", "device": "cpu", "card": null' in out.stdout
