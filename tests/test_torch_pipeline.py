"""Pipeline parallelism in the port (``parallel/pipeline.py``) against the
JAX package's ``pipeline_apply`` and ``pipeline_value_and_grad`` on ``pp``
meshes of virtual CPU devices, from the same numpy inputs:
``tests/test_pipeline.py``'s toy stage ``x + tanh(x @ w + b)``, its linear
squared-error tail and its column-chunked tail for ``sharded_loss``.

The port runs in gloo worlds of two and four ranks (``tests/torch_worlds.py``),
one stage a rank. Tolerances are ``tests/test_pipeline.py``'s: outputs
within atol 1e-5 (rtol 1e-5), the loss within rel 1e-5, every gradient
within atol 1e-5 (rtol 1e-4). The port returns the input cotangent on stage
0 and the stage gradients on their stage (JAX returns the stacked trees).

Also: JAX's error messages, and the residency contract of
``tests/test_pipeline.py::test_backward_residency_bounded_by_depth_not_microbatches``
read on the port's autograd state: the microbatch states a 1F1B stage holds
at once (and the tensors autograd keeps saved) do not grow with M, at most
``2(P−1−s)+1`` microbatches, while GPipe's grow with M.
"""

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401

from tests import torch_worlds

D, K, B = 6, 8, 16
ATOL, RTOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4


def _inputs(P, seed=5, sharded=False):
    rng = np.random.default_rng(seed)
    params = {"w": (rng.standard_normal((P, D, D)) * 0.3).astype(np.float32),
              "b": (rng.standard_normal((P, D)) * 0.1).astype(np.float32)}
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((B, D)).astype(np.float32)
    tgt = rng.standard_normal((B, K if sharded else 3)).astype(np.float32)
    head = rng.standard_normal((D, K if sharded else 3)).astype(np.float32)
    lp = {"head": np.moveaxis(head.reshape(D, P, K // P), 1, 0).copy() if sharded else head}
    return dict(params=params, x=x, tgt=tgt, lp=lp, kp=K // P)


def _case(kind, P, M, **kw):
    return dict(kind=kind, M=M, P=P, **_inputs(P, sharded=kw.get("sharded", False)), **kw)


GRAD_KW = {
    "gpipe": dict(schedule="gpipe"),
    "recompute": dict(schedule="1f1b", backward="recompute"),
    "stored": dict(schedule="1f1b", backward="stored"),
}
CASES = {
    "apply_pp2_m4": _case("apply", 2, 4),
    "apply_pp2_m2_local": _case("apply", 2, 2, layout="local"),
    "apply_pp4_m8": _case("apply", 4, 8),
    **{f"grad_pp2_m8_{name}_{'sharded' if sh else 'last'}": _case("grad", 2, 8, sharded=sh, **kw)
       for name, kw in GRAD_KW.items() for sh in (False, True)},
    "grad_pp2_m4_stored_local": _case("grad", 2, 4, sharded=True, layout="local", **GRAD_KW["stored"]),
    "grad_pp4_m4_gpipe_sharded": _case("grad", 4, 4, sharded=True, **GRAD_KW["gpipe"]),
    "grad_pp4_m8_recompute_last": _case("grad", 4, 8, **GRAD_KW["recompute"]),
    "grad_pp4_m8_stored_sharded": _case("grad", 4, 8, sharded=True, **GRAD_KW["stored"]),
}


def _bad(call, M, n_stages=4, batch=B, **kw):
    case = _case("error", 4, M, call=call, **kw)
    if n_stages != 4:
        case["params"] = _inputs(n_stages)["params"]
    case["x"] = np.zeros((batch, D), np.float32)
    case["tgt"] = np.zeros((batch, K if kw.get("sharded") else 3), np.float32)
    return case


# Each with the pattern of its JAX test (tests/test_pipeline.py).
ERRORS = {
    "bad_split": (_bad("apply", 3, batch=10), "microbatches"),
    "stage_count": (_bad("apply", 4, n_stages=3, batch=8), "pp extent"),
    "m_not_divisible": (_bad("apply", 6, batch=12), "pp extent"),
    "unchunked_gpipe": (dict(_bad("grad", 8, sharded=True, schedule="gpipe"),
                             lp={"head": np.zeros((D, K), np.float32)}), "stage-chunked"),
    "unchunked_1f1b": (dict(_bad("grad", 8, sharded=True, schedule="1f1b"),
                            lp={"head": np.zeros((D, K), np.float32)}), "stage-chunked"),
    "bad_schedule": (_bad("grad", 4, schedule="interleaved"), "schedule"),
    "bad_backward": (_bad("grad", 4, backward="saved"), "backward"),
}
# The residency cases: P=2, B/M held at 2 rows.
RESIDENCY = {(sched, M): dict(_case("grad", 2, M, **GRAD_KW[sched]),
                              x=np.ones((2 * M, D), np.float32), tgt=np.ones((2 * M, 3), np.float32))
             for sched in GRAD_KW for M in (4, 16)}


@pytest.fixture(scope="module")
def port():
    """The port's cases: those of two stages (and the residency cases) in a
    two-rank world, those of four (and the errors) in a four-rank one."""
    two = [c for c in CASES.values() if c["P"] == 2] + list(RESIDENCY.values())
    four = [c for c in CASES.values() if c["P"] == 4] + [c for c, _ in ERRORS.values()]
    got2 = torch_worlds.run_world("pipeline", two, n=2)
    got4 = torch_worlds.run_world("pipeline", four, n=4, timeout=240)
    names2 = [n for n, c in CASES.items() if c["P"] == 2] + list(RESIDENCY)
    names4 = [n for n, c in CASES.items() if c["P"] == 4] + list(ERRORS)
    out = {}
    for names, ranks in ((names2, got2), (names4, got4)):
        out.update({name: [r[i] for r in ranks] for i, name in enumerate(names)})
    return out


def _jax(case):
    """JAX's pipeline on a pp mesh of case["P"] virtual devices: the output,
    or ``(loss, (d_stage, d_loss, dx))``."""
    import jax
    import jax.numpy as jnp

    from pytorch_operator_tpu.parallel import make_mesh
    from pytorch_operator_tpu.parallel.pipeline import pipeline_apply, pipeline_value_and_grad

    P, M = case["P"], case["M"]
    mesh = make_mesh(f"pp={P}", devices=jax.devices()[:P])
    params = jax.tree.map(jnp.asarray, case["params"])
    x = jnp.asarray(case["x"])

    def stage(p, a):
        return a + jnp.tanh(a @ p["w"] + p["b"])

    if case["kind"] == "apply":
        return np.asarray(jax.jit(lambda p, a: pipeline_apply(stage, p, a, mesh=mesh, microbatches=M))(
            params, x))
    kp = case["kp"]

    def toy(lp, y, tgt):
        return ((y @ lp["head"] - tgt) ** 2).mean()

    def sharded(lp, y, tgt):
        off = jax.lax.axis_index("pp") * kp
        part = ((y @ lp["head"] - jax.lax.dynamic_slice_in_dim(tgt, off, kp, 1)) ** 2).sum()
        return jax.lax.psum(part, "pp") / (tgt.shape[0] * tgt.shape[1])

    sh = case.get("sharded", False)
    tgt = jnp.asarray(case["tgt"])
    f = jax.jit(lambda p, l, a: pipeline_value_and_grad(
        stage, sharded if sh else toy, p, l, a, tgt, mesh=mesh, microbatches=M,
        schedule=case["schedule"], sharded_loss=sh, backward=case.get("backward", "recompute")))
    return jax.device_get(f(params, jax.tree.map(jnp.asarray, case["lp"]), x))


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_pipeline_matches_jax(name, port):
    case, ranks = CASES[name], port[name]
    want = _jax(case)
    if case["kind"] == "apply":
        for r in ranks:  # the whole output on every stage
            np.testing.assert_allclose(r["y"], want, rtol=RTOL, atol=ATOL)
        return
    loss, (dsp, dlp, dx) = want
    sh = case.get("sharded", False)
    for s, r in enumerate(ranks):
        assert r["loss"] == pytest.approx(float(loss), rel=1e-5)
        for k, g in r["dsp"].items():
            np.testing.assert_allclose(g[s if case.get("layout") != "local" else 0], dsp[k][s],
                                       rtol=GRAD_RTOL, atol=ATOL, err_msg=f"stage {s} d{k}")
        for k, g in r["dlp"].items():
            if sh:  # this stage's chunk
                g = g[s if case.get("layout") != "local" else 0]
                np.testing.assert_allclose(g, dlp[k][s], rtol=GRAD_RTOL, atol=ATOL, err_msg=k)
            else:  # the last stage's, replicated
                np.testing.assert_allclose(g, dlp[k], rtol=GRAD_RTOL, atol=ATOL, err_msg=k)
        if s == 0:
            np.testing.assert_allclose(r["dx"], dx, rtol=GRAD_RTOL, atol=ATOL)
        else:
            assert r["dx"] is None


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_port_pipeline_refuses_as_jax(name, port):
    """The same call refused on every rank with JAX's message."""
    case, pattern = ERRORS[name]
    msgs = port[name]
    with pytest.raises(ValueError, match=pattern) as jax_err:
        jax_case = dict(case, kind="apply" if case["call"] == "apply" else "grad")
        jax_case.setdefault("schedule", "1f1b")
        _jax(jax_case)
    assert msgs == [str(jax_err.value)] * len(msgs), (msgs, str(jax_err.value))


@pytest.mark.parametrize("schedule", sorted(GRAD_KW))
def test_1f1b_residency_bounded_by_depth_not_microbatches(schedule, port):
    """Counted in the tensors autograd keeps saved, ``per_mb`` of them for
    one microbatch's stage forward: 1F1B holds at most 2(P−1−s)+1
    microbatches' at stage s (plus the last stage's loss, ``per_tail``,
    backwarded within its tick), the same at M=4 and M=16; GPipe holds all
    M, 12 microbatches' more at M=16. Every saved tensor is released by the
    end."""
    small, big = port[(schedule, 4)], port[(schedule, 16)]
    for s in range(2):
        a, b = small[s], big[s]
        per_mb, tail = a["per_mb"], a["per_tail"] if s == 1 else 0
        assert per_mb > 0 and a["saved_after"] == b["saved_after"] == 0
        if schedule == "gpipe":
            assert a["saved_max"] >= 4 * per_mb, (s, a)
            assert b["saved_max"] >= a["saved_max"] + 12 * per_mb, (s, a, b)
        else:
            assert a["saved_max"] == b["saved_max"] <= (2 * (1 - s) + 1) * per_mb + tail, (s, a, b)
