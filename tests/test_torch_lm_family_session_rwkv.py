"""A MoDeST session that trains RWKV-6 in the PyTorch package against the
reference's (helpers and tiers of ``test_torch_lm_family_session.py``).

RWKV-6's training is chaotic at these configs, in the reference itself
(ROADMAP C12): its bonus ``u`` takes gradients in the hundreds, and SGD at
lr 0.05 moves it by several units a step, so a change of one part in
1e6 of the initial weights moves the reference's own loss by about 1 %
two evaluations on. Its session is held at 1e-5 through the first
evaluated round (its loss; its model's parameters at 1e-5 in every
leaf where an ulp's nudge of the reference's init moves the reference's
own model less) and exactly in rounds, times, bytes and logs throughout,
and the test pins the reference's own sensitivity.
"""

import jax
import numpy as np

from repro_torch.engine.flat import as_buffer

from test_torch_lm_family_session import TOL, _init, _run, _same_events
from test_torch_threads import one_torch_thread  # noqa: F401


def check_first_model_within_own_rounding(arch, init, sess, jsess):
    """The first evaluated model, leaf by leaf: within 1e-5 of the
    reference's, bar the leaves where the reference's own model moves
    further when its initial weights move by one part in 1e7 (about an
    ulp); those within twice that move of it. They are the bonus ``u``
    (about 1.7e-4 at a scale of 5) and the embedding, no other."""
    first = min(sess._eval_models)
    assert first == min(jsess._eval_models)
    rng = np.random.default_rng(2)
    ulp = jax.tree.map(
        lambda x: x * (1 + 1e-7 * rng.standard_normal(x.shape)
                       ).astype(np.float32), init)
    own = np.asarray(_run("jax", arch, ulp)[0]._eval_models[first].buffer)
    want = np.asarray(jsess._eval_models[first].buffer)
    got = as_buffer(sess._eval_models[first], sess.task.flat_spec).numpy()
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(init)[0]]
    spec = sess.task.flat_spec
    loose = []
    for path, o, n in zip(paths, spec.offsets, spec.sizes):
        g, w, own_gap = got[o:o + n], want[o:o + n], np.abs(
            own[o:o + n] - want[o:o + n]).max()
        if own_gap <= TOL["atol"]:
            np.testing.assert_allclose(g, w, err_msg=path, **TOL)
        else:
            loose.append(path)
            assert np.abs(g - w).max() <= 2 * own_gap, path
    assert set(loose) <= {"['embed']", "['layers']['tm']['u']"}, loose


def test_rwkv_session_equals_reference_where_the_reference_is_stable():
    """RWKV-6 (ROADMAP C12): rounds, times, bytes and logs exact for the
    whole session, the first evaluated round's loss within 1e-5 and its
    model as close as the reference's own rounding allows; and the
    reference's own loss two evaluations on moves by more than 1e-3 when
    its initial weights move by one part in 1e6, which no port can hold
    to 1e-5."""
    arch = "rwkv6-1.6b"
    init = _init(arch)
    jsess, ref = _run("jax", arch, init)
    sess, got = _run("torch", arch, init)
    _same_events(sess, got, jsess, ref, None)
    np.testing.assert_allclose(got.history[0]["loss"],
                               ref.history[0]["loss"], **TOL)
    check_first_model_within_own_rounding(arch, init, sess, jsess)

    rng = np.random.default_rng(1)
    nudged = jax.tree.map(
        lambda x: x * (1 + 1e-6 * rng.standard_normal(x.shape)
                       ).astype(np.float32), init)
    ref2 = _run("jax", arch, nudged)[1]
    assert abs(ref2.history[1]["loss"] - ref.history[1]["loss"]) > 1e-3
