"""The PyTorch package's ``roofline.py`` and the smaller surfaces it rests
on against the reference's: ``param_stats``, ``analytic_terms``,
``aggregation_roofline``; ``config.SHAPES``, ``ShapeConfig``,
``HardwareSpec``, ``parse_overrides``; the pytree arithmetic of
``utils/pytree.py``; ``optim.cosine_schedule``.

Tiers: exact for counts, bytes, FLOPs and parsed values, every arch of
``configs.ARCHS`` at its published size (``analytic_terms``: every LM arch
x ``SHAPES``); the time terms are those quantities over ``config.H100``'s
constants, and over the reference's TPU constants (``config.V5E``, kept
for this comparison) they are the reference's own seconds. The pytree
arithmetic is elementwise and exact; the cosine schedule is held at
``rtol = atol = 1e-6``. The roofline's aggregation bytes are also held to
``chip_smoke.py``'s B1/B2 bounds (``roofline_rows``, the same check the
card runs), which count the P weights on top (within 0.01 %).
"""

import dataclasses
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro import roofline as jroof
from repro.config import SHAPES as JSHAPES
from repro.config import V5E as JV5E
from repro.config import HardwareSpec as JHardwareSpec
from repro.config import parse_overrides as j_parse_overrides
from repro.models import build as jbuild
from repro.utils import pytree as jpt
from repro_torch import configs, optim, roofline
from repro_torch.config import (H100, SHAPES, V5E, HardwareSpec, ShapeConfig,
                                parse_overrides)
from repro_torch.models import build
from repro_torch.utils import pytree as pt
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TIME_KEYS = {"compute_s": ("flops", "peak_flops_bf16"),
             "memory_s": ("hbm_bytes", "hbm_bandwidth")}


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_param_stats_equal_reference(arch):
    assert roofline.param_stats(configs.get_config(arch)) == \
        jroof.param_stats(jconfigs.get_config(arch))


@pytest.mark.parametrize("arch", configs.ASSIGNED)
def test_analytic_terms_equal_reference(arch):
    """Every shape, at two card counts: FLOPs, model FLOPs, bytes and their
    ratio exact; each time term is its quantity over the card's rate."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for name in SHAPES:
        for chips, P, coll in ((256, 16, 10 ** 9), (1, 1, 0)):
            kw = dict(n_participants=P, collective_total_bytes=coll,
                      chips=chips)
            got = roofline.analytic_terms(cfg, SHAPES[name], **kw)
            want = jroof.analytic_terms(jcfg, JSHAPES[name], **kw)
            for k in ("params", "param_bytes", "flops", "model_flops",
                      "useful_flop_ratio", "hbm_bytes"):
                assert got[k] == want[k], (name, k)
            for k, (q, rate) in TIME_KEYS.items():
                assert got[k] == got[q] / (chips * getattr(H100, rate))
                assert want[k] == got[q] / (chips * getattr(V5E, rate))
            assert got["collective_s"] == coll / (chips * H100.ici_bandwidth)
            assert want["collective_s"] == coll / (chips * V5E.ici_bandwidth)
            assert got["dominant"] == max(
                ("compute", "memory", "collective"),
                key=lambda t: got[f"{t}_s"])
    # the default card count is the reference's
    assert roofline.analytic_terms(cfg, SHAPES["decode_32k"],
                                   n_participants=1)["memory_s"] == \
        roofline.analytic_terms(cfg, SHAPES["decode_32k"], n_participants=1,
                                chips=256)["memory_s"]


@pytest.mark.parametrize("fused_quantize", [False, True])
def test_aggregation_roofline_equals_reference(fused_quantize):
    """Bytes exact over a grid; the times are the bytes over the cards'
    HBM rate, unrounded (the reference rounds its to 0.01 µs)."""
    for N in (1, 11_173, 16_384, 136_672, 2 ** 24 - 1003, 219_162_624):
        for P in (1, 4, 10, 16):
            for itemsize, chips in ((4, 1), (2, 1), (4, 8)):
                kw = dict(itemsize=itemsize, fused_quantize=fused_quantize,
                          chips=chips)
                got = roofline.aggregation_roofline(N, P, **kw)
                want = jroof.aggregation_roofline(N, P, **kw)
                assert sorted(got) == ["onepass_bytes", "onepass_us",
                                       "per_leaf_bytes", "per_leaf_us"]
                for k in ("onepass", "per_leaf"):
                    nbytes = got[f"{k}_bytes"]
                    assert nbytes == want[f"{k}_bytes"]
                    assert got[f"{k}_us"] == \
                        nbytes / (chips * H100.hbm_bandwidth) * 1e6
                    assert want[f"{k}_tpu_us"] == round(
                        nbytes / (chips * V5E.hbm_bandwidth) * 1e6, 2)


def test_aggregation_roofline_agrees_with_the_smoke_bounds():
    """``chip_smoke.py``'s ``roofline`` phase on the CPU: B1's and B2's
    bounds at the CNN, MF and TinyLlama-session stacks within 0.01 % of
    the roofline's one-pass times, and the smoke's card constants those
    of ``config.H100``."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_roofline", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rows = smoke.roofline_rows()
    assert [(r["P"], r["N"]) for r in rows] == [
        (10, 136_672), (10, 11_173), (4, 219_162_624)]
    for r in rows:
        for kind in ("fused.agg", "fused.agg_quant"):
            assert 0 < r[kind]["rel_gap"] <= smoke.ROOFLINE_REL_TOL


def test_shapes_hardware_and_overrides_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert all(isinstance(v, ShapeConfig) for v in SHAPES.values())
    assert SHAPES is configs.SHAPES
    names = [f.name for f in dataclasses.fields(HardwareSpec)]
    jnames = [f.name for f in dataclasses.fields(JHardwareSpec)]
    assert names[:len(jnames)] == jnames
    for name in jnames:
        assert getattr(V5E, name) == getattr(JV5E, name)
    assert H100 == HardwareSpec()
    assert (H100.hbm_bandwidth, H100.peak_flops_bf16, H100.hbm_bytes,
            H100.ici_bandwidth, H100.peak_flops_fp32, H100.peak_ops_int32,
            H100.n_sms, H100.sm_clock_hz) == (3.35e12, 989e12, 80e9, 900e9,
                                              67e12, 33.5e12, 132, 1.98e9)
    # the INT32 peak is 64 lanes an SM a clock, a multiply-add as two
    assert math.isclose(H100.peak_ops_int32,
                        64 * H100.n_sms * H100.sm_clock_hz * 2, rel_tol=2e-3)
    pairs = ["lr=0.1", "n_layers=4", "use_flash=true", "remat=False",
             "name=x", " window = 64", "eps=1e-5", "flag=True", "neg=-3",
             "empty=", "tag=a=b"]
    for case in (pairs, [], None, ["use_flash=false"]):
        got, want = parse_overrides(case), j_parse_overrides(case)
        assert got == want
        assert [type(v) for v in got.values()] == \
            [type(v) for v in want.values()]


def _trees(seed):
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal((3, 5)).astype(np.float32),
             "layers": {"b": rng.standard_normal(7).astype(np.float32),
                        "s": np.float32(rng.standard_normal())}}
            for _ in range(2)]


def test_pytree_arithmetic_equals_reference():
    (a, b), alpha = _trees(0), 0.3
    ja, jb = jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, b)
    ta, tb = pt.tree_map(torch.as_tensor, a), pt.tree_map(torch.as_tensor, b)
    pairs = [(pt.tree_add(ta, tb), jpt.tree_add(ja, jb)),
             (pt.tree_sub(ta, tb), jpt.tree_sub(ja, jb)),
             (pt.tree_scale(ta, alpha), jpt.tree_scale(ja, alpha)),
             (pt.tree_axpy(alpha, ta, tb), jpt.tree_axpy(alpha, ja, jb)),
             (pt.tree_cast(ta, torch.bfloat16),
              jpt.tree_cast(ja, jnp.bfloat16))]
    for got, want in pairs:
        gl, wl = pt.tree_leaves(got), jax.tree.leaves(want)
        assert len(gl) == len(wl) == 3
        for g, w in zip(gl, wl):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape
            np.testing.assert_array_equal(g.float().numpy(),
                                          w.astype(np.float32))
    assert pt.tree_num_params(ta) == jpt.tree_num_params(ja) == 23
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b"))
    tree = build(cfg).init(torch.Generator(), "meta")
    jtree = jax.eval_shape(jbuild(jconfigs.reduced(jconfigs.get_config(
        "tinyllama-1.1b"))).init, jax.random.key(0))
    assert pt.tree_num_params(tree) == jpt.tree_num_params(jtree) == \
        roofline.param_stats(cfg)["total"]


@pytest.mark.parametrize("base_lr,total,warmup",
                         [(0.1, 100, 0), (0.3, 50, 10), (1.0, 7, 7)])
def test_cosine_schedule_equals_reference(base_lr, total, warmup):
    got = optim.cosine_schedule(base_lr, total, warmup)
    want = joptim.cosine_schedule(base_lr, total, warmup)
    for step in list(range(total + 5)) + [0.5, 2.5]:
        g = got(step)
        assert g.dtype == torch.float32 and g.shape == ()
        np.testing.assert_allclose(float(g), float(want(step)),
                                   rtol=1e-6, atol=1e-6)
    steps = np.arange(total + 3)
    np.testing.assert_allclose(got(torch.as_tensor(steps)).numpy(),
                               np.asarray(want(jnp.asarray(steps))),
                               rtol=1e-6, atol=1e-6)
