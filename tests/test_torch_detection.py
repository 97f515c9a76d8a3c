"""The port's detection heads (bigdl_tpu_torch/nn/detection.py) against
the JAX package's (bigdl_tpu/nn/detection.py) on the same numpy inputs.

Each test of tests/test_detection.py on this module, and the three
``DetectionOutputFrcnn`` cases of tests/test_parity_tails.py, has a
counterpart here (the vision transforms of tests/test_detection.py are
held byte for byte in tests/test_torch_vision_data.py; its image-frame
pipeline is repeated here). The traps each have a test with the wrong
form shown apart from JAX: a max over rows, then columns, splits a tied
cell's gradient otherwise than ``jnp.max``; a per-candidate loop makes
``nms``'s launches grow with k; a sort that is not stable (or the
reverse of one) orders tied scores otherwise; a stable sort in
``Proposal`` keeps other rois than numpy's default ``argsort``.
Tolerances: boxes, scores and pooled values rtol 1e-5, atol 1e-6
(float32 decode on both sides); kept sets, labels and counts exactly.

The JAX references run their jittable parts under ``jax.jit``: ``nms``
and the box math (also where the JAX heads call them, through
``_jax_jitted``; ``nms``'s own test jits it) and ``RoiPooling``'s
forward and gradient. Op by op, each new shape costs ~2 s of compiles;
one program costs ~0.2 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn import detection as jdet
from bigdl_tpu.transform import vision as jvision
from bigdl_tpu.utils.table import Table as JaxTable
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.transform import vision
from bigdl_tpu_torch.utils.table import Table

TOL = dict(rtol=1e-5, atol=1e-6)
_JAX_NMS = jax.jit(jdet.nms, static_argnums=(2, 3))
_JAX_JITTED = {
    "nms": _JAX_NMS, "bbox_iou": jax.jit(jdet.bbox_iou),
    "bbox_transform_inv": jax.jit(jdet.bbox_transform_inv),
    "clip_boxes": jax.jit(jdet.clip_boxes),
    "decode_boxes": jax.jit(jdet.decode_boxes, static_argnums=(3,),
                            static_argnames=("clip",))}


@pytest.fixture
def _jax_jitted(monkeypatch):
    """The JAX heads' ``nms`` and box math through one jitted program a
    shape each."""
    for name, fn in _JAX_JITTED.items():
        monkeypatch.setattr(jdet, name, fn)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _both(*arrays):
    """(port Table, JAX Table) of the same float32 arrays."""
    arrays = [np.asarray(a, np.float32) for a in arrays]
    return (Table(*[torch.tensor(a) for a in arrays]),
            JaxTable(*[jnp.asarray(a) for a in arrays]))


# ------------------------------------------------------------------ box math
def test_bbox_iou():
    a = np.asarray([[0, 0, 10, 10.0]], np.float32)
    b = np.asarray([[0, 0, 10, 10.0], [5, 5, 15, 15], [20, 20, 30, 30]],
                   np.float32)
    iou = _np(tnn.bbox_iou(torch.tensor(a), torch.tensor(b)))
    np.testing.assert_allclose(iou, np.asarray(jnn.bbox_iou(a, b)), **TOL)
    np.testing.assert_allclose(iou[0], [1.0, 25 / 175, 0.0], rtol=1e-5)


def test_decode_boxes_identity_and_shift():
    priors = np.asarray([[0.2, 0.2, 0.4, 0.4]], np.float32)
    vars_ = np.asarray([[0.1, 0.1, 0.2, 0.2]], np.float32)
    for d in ([[0.0, 0, 0, 0]], [[1.0, 0, 0, 0]], [[0.3, -0.2, 0.5, -1.0]]):
        d = np.asarray(d, np.float32)
        for enc in (False, True):
            out = tnn.decode_boxes(torch.tensor(priors), torch.tensor(vars_),
                                   torch.tensor(d), enc, clip=True)
            np.testing.assert_allclose(_np(out), np.asarray(jnn.decode_boxes(
                priors, vars_, d, enc, clip=True)), **TOL)
    out = tnn.decode_boxes(priors, vars_, np.asarray([[1.0, 0, 0, 0]]))
    np.testing.assert_allclose(_np(out), [[0.22, 0.2, 0.42, 0.4]], atol=1e-6)


def test_anchor_generation():
    a = tnn.Anchor(ratios=[1.0], scales=[8.0])
    assert a.num == 1
    assert a.base_anchors[0][2] - a.base_anchors[0][0] + 1 == 128
    grid = a.generate_anchors(2, 2, feat_stride=16.0)
    assert grid.shape == (4, 4)
    np.testing.assert_allclose(grid[1] - grid[0], [16, 0, 16, 0])
    ours = tnn.Anchor([0.5, 1.0, 2.0], [8, 16, 32])
    theirs = jnn.Anchor([0.5, 1.0, 2.0], [8, 16, 32])
    np.testing.assert_array_equal(ours.generate_anchors(5, 3),
                                  theirs.generate_anchors(5, 3))


# ----------------------------------------------------------------------- NMS
def test_nms_suppresses_overlaps():
    boxes = np.asarray([[0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30.0]],
                       np.float32)
    scores = np.asarray([0.9, 0.8, 0.7], np.float32)
    keep, count = tnn.nms(torch.tensor(scores), torch.tensor(boxes), 0.5, 3)
    jkeep, jcount = _JAX_NMS(scores, boxes, 0.5, 3)
    assert int(count) == int(jcount) == 2
    assert keep.dtype == torch.int32
    np.testing.assert_array_equal(_np(keep), np.asarray(jkeep))
    assert set(_np(keep)[:2].tolist()) == {0, 2}
    assert tnn.Nms()(torch.tensor(scores), torch.tensor(boxes), 0.5, 3)[
        1].item() == 2


def _random_boxes(rs, n, size=60.0):
    xy = rs.rand(n, 2) * size
    wh = rs.rand(n, 2) * size / 3 + 1
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_nms_matches_jax_on_random_boxes():
    rs = np.random.RandomState(3)
    boxes = _random_boxes(rs, 80)
    scores = rs.rand(80).astype(np.float32)
    keep, count = tnn.nms(torch.tensor(scores), torch.tensor(boxes), 0.4, 50)
    jkeep, jcount = _JAX_NMS(scores, boxes, 0.4, 50)
    assert int(count) == int(jcount)
    np.testing.assert_array_equal(_np(keep), np.asarray(jkeep))


def test_nms_tied_scores_keep_the_jax_order():
    """Tied scores keep index order (JAX's ``argsort`` is stable); the
    reverse of an ascending stable sort, a wrong form, does not."""
    scores = np.asarray([0.5, 0.9, 0.5], np.float32)
    boxes = np.asarray([[i * 20, 0, i * 20 + 10, 10] for i in range(3)],
                       np.float32)
    keep, _ = tnn.nms(torch.tensor(scores), torch.tensor(boxes), 0.5, 3)
    jkeep, _ = _JAX_NMS(scores, boxes, 0.5, 3)
    np.testing.assert_array_equal(_np(keep), np.asarray(jkeep))
    np.testing.assert_array_equal(_np(keep), [1, 0, 2])
    wrong = torch.sort(torch.tensor(scores), stable=True).indices.flip(0)
    assert not np.array_equal(_np(wrong), np.asarray(jkeep))


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def _loop_nms(scores, boxes, thresh, k):
    """The wrong form: JAX's ``fori_loop`` body as a torch loop."""
    order = torch.sort(-scores, stable=True).indices[:k]
    iou = tnn.bbox_iou(boxes[order], boxes[order])
    keep = torch.ones(k, dtype=torch.bool)
    for i in range(k):
        keep[i] = ~((iou[i] > thresh) & keep & (torch.arange(k) < i)).any()
    return keep


def test_nms_op_count_does_not_grow_with_k():
    """The ATen operations of one ``nms`` call (counted on the CPU by a
    dispatch mode, as the card would count launches) are the same at
    k = 50 and k = 400; the per-candidate loop's grow with k (shown at 10
    and 40)."""
    rs = np.random.RandomState(0)
    boxes = torch.tensor(_random_boxes(rs, 400))
    scores = torch.tensor(rs.rand(400).astype(np.float32))
    counts = {}
    for name, fn, ks in (("port", tnn.nms, (50, 400)),
                         ("loop", _loop_nms, (10, 40))):
        for k in ks:
            with _OpCount() as c:
                fn(scores, boxes, 0.5, k)
            counts[name, k] = c.ops
    assert counts["port", 50] == counts["port", 400], counts
    assert counts["loop", 40] > 3 * counts["loop", 10], counts


# ------------------------------------------------------------------ PriorBox
def _prior_pair(**kw):
    return tnn.PriorBox(**kw), jnn.PriorBox(**kw)


def test_prior_box_shapes_and_values():
    pb, jpb = _prior_pair(min_sizes=[30.0], max_sizes=[60.0],
                          aspect_ratios=[2.0], is_flip=True, is_clip=False,
                          variances=[0.1, 0.1, 0.2, 0.2], img_h=300,
                          img_w=300, step_h=100.0, step_w=100.0)
    assert pb.num_priors == jpb.num_priors == 4
    out = _np(pb(torch.zeros(1, 8, 3, 3)))
    assert out.shape == (1, 2, 3 * 3 * 4 * 4)
    np.testing.assert_array_equal(out, np.asarray(jpb(jnp.zeros((1, 8, 3,
                                                                 3)))))
    np.testing.assert_allclose(
        out[0, 0].reshape(-1, 4)[0], [(50 - 15) / 300, (50 - 15) / 300,
                                      (50 + 15) / 300, (50 + 15) / 300],
        rtol=1e-5)
    np.testing.assert_allclose(out[0, 1].reshape(-1, 4)[0],
                               [0.1, 0.1, 0.2, 0.2])


def test_prior_box_derives_img_size_from_table_and_caches():
    pb, jpb = _prior_pair(min_sizes=[30.0], max_sizes=[60.0],
                          aspect_ratios=[2.0, 3.0], is_clip=True,
                          step_h=100.0, step_w=100.0)
    fmap, data = torch.zeros(1, 8, 3, 3), torch.zeros(1, 3, 300, 300)
    out1 = pb(Table(fmap, data))
    assert pb(Table(fmap, data)) is out1
    np.testing.assert_array_equal(_np(out1), np.asarray(jpb(JaxTable(
        jnp.zeros((1, 8, 3, 3)), jnp.zeros((1, 3, 300, 300))))))
    with pytest.raises(ValueError, match="img_h"):
        tnn.PriorBox(min_sizes=[30.0])(fmap)


# ---------------------------------------------------------------- RoiPooling
def test_roi_pooling_matches_manual():
    feats = np.arange(16.0, dtype=np.float32).reshape(1, 1, 4, 4)
    rois = np.asarray([[0, 0, 0, 3, 3.0]], np.float32)
    out = _np(tnn.RoiPooling(2, 2, 1.0)(Table(torch.tensor(feats),
                                              torch.tensor(rois))))
    assert out.shape == (1, 1, 2, 2)
    np.testing.assert_array_equal(out, _jax_roi((2, 2, 1.0), feats, rois))
    np.testing.assert_array_equal(out[0, 0], [[5, 7], [13, 15]])


def test_roi_pooling_respects_batch_index_and_scale():
    feats = np.stack([np.zeros((1, 4, 4)), np.arange(16.0).reshape(
        1, 4, 4)]).astype(np.float32)
    rois = np.asarray([[1, 0, 0, 6, 6.0]], np.float32)
    out = _np(tnn.RoiPooling(1, 1, 0.5)(Table(torch.tensor(feats),
                                              torch.tensor(rois))))
    np.testing.assert_array_equal(out, _jax_roi((1, 1, 0.5), feats, rois))
    np.testing.assert_array_equal(out[0, 0], [[15.0]])


def _jax_roi(pooled, feats, rois):
    layer = jnn.RoiPooling(*pooled)
    return np.asarray(jax.jit(lambda f, r: layer.forward(JaxTable(f, r)))(
        jnp.asarray(feats), jnp.asarray(rois)))


def _jax_roi_grad(pooled, feats, rois, g):
    layer = jnn.RoiPooling(*pooled)
    return np.asarray(jax.jit(jax.grad(lambda f: jnp.sum(layer.forward(
        JaxTable(f, jnp.asarray(rois))) * g)))(jnp.asarray(feats)))


def _port_roi(pooled, feats, rois, g):
    f = torch.tensor(feats, requires_grad=True)
    out = tnn.RoiPooling(*pooled)(Table(f, torch.tensor(rois)))
    (out * torch.tensor(g)).sum().backward()
    return _np(out), _np(f.grad)


def test_roi_pooling_matches_jax_with_ties_and_empty_cells():
    """ReLU'd features (exact zeros, so ties) under rois that run off the
    map, round half to even (2.5 -> 2) and leave empty cells; the
    forward and the feature gradient are JAX's."""
    rs = np.random.RandomState(3)
    feats = np.maximum(rs.randn(2, 3, 9, 11), 0).astype(np.float32)
    feats[0, 1, 2:5, 3:6] = 1.25                   # a flat plateau
    rois = np.asarray([[0, 0, 0, 20, 16], [1, 5, 3, 9, 7],
                       [0, 14, 10, 40, 40], [1, 5, 5, 5, 5],
                       [0, -6, -4, 7, 3], [1, 21, 17, 3, 1]], np.float32)
    pooled = (3, 2, 0.5)
    g = rs.randn(6, 3, 2, 3).astype(np.float32)
    out, grad = _port_roi(pooled, feats, rois, g)
    np.testing.assert_allclose(out, _jax_roi(pooled, feats, rois), **TOL)
    np.testing.assert_allclose(grad, _jax_roi_grad(pooled, feats, rois, g),
                               **TOL)


def test_roi_pooling_splits_a_tied_gradient_as_jnp_max():
    """One cell over a 3 x 3 map holding its max three times, twice in
    row 0 and once in row 2: ``jnp.max`` gives each a third; the
    separable max (rows, then columns), a wrong form, gives 1/4, 1/4,
    1/2."""
    feats = np.zeros((1, 1, 3, 3), np.float32)
    feats[0, 0, 0, 0] = feats[0, 0, 0, 2] = feats[0, 0, 2, 1] = 2.0
    rois = np.asarray([[0, 0, 0, 2, 2]], np.float32)
    g = np.ones((1, 1, 1, 1), np.float32)
    ref = _jax_roi_grad((1, 1, 1.0), feats, rois, g)
    _, grad = _port_roi((1, 1, 1.0), feats, rois, g)
    np.testing.assert_allclose(grad, ref, **TOL)
    np.testing.assert_allclose(ref[0, 0][feats[0, 0] == 2.0], 1 / 3,
                               rtol=1e-6)
    f = torch.tensor(feats, requires_grad=True)
    f.amax(dim=-1).amax(dim=-1).sum().backward()
    assert np.abs(_np(f.grad) - ref).max() > 0.1


def test_roi_pooling_bounds_its_gathered_chunks(monkeypatch):
    """Chunks of one roi give the same pooled values as one chunk."""
    rs = np.random.RandomState(1)
    feats = torch.tensor(rs.rand(1, 4, 10, 10).astype(np.float32))
    rois = torch.tensor([[0, 0, 0, 9, 9], [0, 2, 3, 7, 8], [0, 4, 4, 9, 6]],
                        dtype=torch.float32)
    whole = tnn.RoiPooling(3, 3, 1.0)(Table(feats, rois))
    from bigdl_tpu_torch.nn import detection
    monkeypatch.setattr(detection, "ROI_CHUNK_ELEMENTS", 1)
    torch.testing.assert_close(tnn.RoiPooling(3, 3, 1.0)(Table(feats, rois)),
                               whole, rtol=0, atol=0)


# ------------------------------------------------------------------ Proposal
def _proposal_inputs(rs, a, h, w, ties=False):
    scores = rs.rand(1, 2 * a, h, w).astype(np.float32)
    if ties:
        scores = (np.round(scores * 3) / 3).astype(np.float32)
    deltas = (0.1 * rs.randn(1, 4 * a, h, w)).astype(np.float32)
    return scores, deltas


@pytest.mark.usefixtures("_jax_jitted")
def test_proposal_emits_rois():
    rs = np.random.RandomState(0)
    kw = dict(pre_nms_topn=50, post_nms_topn=5, ratios=[1.0], scales=[4.0])
    prop, jprop = tnn.Proposal(**kw), jnn.Proposal(**kw)
    prop.evaluate()
    jprop.evaluate()
    t, j = _both(*_proposal_inputs(rs, 1, 4, 4), [64.0, 64.0, 1.0, 1.0])
    rois = _np(prop(t))
    np.testing.assert_allclose(rois, np.asarray(jprop(j)), **TOL)
    assert rois.shape[1] == 5 and 1 <= rois.shape[0] <= 5
    assert np.all(rois[:, 0] == 0)
    assert np.all(rois[:, 1] >= 0) and np.all(rois[:, 3] <= 63)


@pytest.mark.usefixtures("_jax_jitted")
def test_proposal_matches_jax_with_several_anchors_in_training():
    """Six anchors a cell, a scale in ``im_info`` and the training counts
    (``rpn_pre_nms_topn_train``, ``rpn_post_nms_topn_train``)."""
    rs = np.random.RandomState(5)
    kw = dict(pre_nms_topn=60, post_nms_topn=12, ratios=[0.5, 1.0, 2.0],
              scales=[2.0, 4.0], rpn_pre_nms_topn_train=40,
              rpn_post_nms_topn_train=20, min_size=4)
    prop, jprop = tnn.Proposal(**kw), jnn.Proposal(**kw)
    prop.train(True)
    jprop.training = True
    t, j = _both(*_proposal_inputs(rs, 6, 4, 6), [64.0, 96.0, 1.2])
    np.testing.assert_allclose(_np(prop(t)), np.asarray(jprop(j)), **TOL)


@pytest.mark.usefixtures("_jax_jitted")
def test_proposal_orders_tied_scores_as_numpy():
    """Scores of three levels, so many ties: the pre-sort is numpy's
    default ``argsort``, not stable, and the kept rois are JAX's; a stable
    sort (the wrong form) keeps other rois."""
    rs = np.random.RandomState(7)
    kw = dict(pre_nms_topn=40, post_nms_topn=10, ratios=[0.5, 1.0, 2.0],
              scales=[2.0, 4.0], min_size=4)
    prop, jprop = tnn.Proposal(**kw), jnn.Proposal(**kw)
    prop.evaluate()
    jprop.evaluate()
    scores, deltas = _proposal_inputs(rs, 6, 4, 6, ties=True)
    t, j = _both(scores, deltas, [64.0, 96.0, 1.0])
    rois = _np(prop(t))
    np.testing.assert_allclose(rois, np.asarray(jprop(j)), **TOL)
    s = scores[0, 6:].transpose(1, 2, 0).reshape(-1)
    assert not np.array_equal(np.argsort(-s)[:40],
                              np.argsort(-s, kind="stable")[:40])


def test_proposal_drops_small_boxes():
    rs = np.random.RandomState(0)
    kw = dict(pre_nms_topn=50, post_nms_topn=10, ratios=[1.0], scales=[1.0],
              min_size=64)
    prop, jprop = tnn.Proposal(**kw), jnn.Proposal(**kw)
    prop.evaluate()
    jprop.evaluate()
    scores = rs.rand(1, 2, 2, 2).astype(np.float32)
    t, j = _both(scores, np.zeros((1, 4, 2, 2)), [64.0, 64.0, 1.0])
    rois = prop(t)
    assert tuple(rois.shape) == np.asarray(jprop(j)).shape == (0, 5)


# -------------------------------------------------------- DetectionOutputSSD
@pytest.mark.usefixtures("_jax_jitted")
def test_detection_output_ssd():
    priors = np.asarray([[0.1, 0.1, 0.3, 0.3], [0.5, 0.5, 0.9, 0.9]],
                        np.float32)
    pr = np.stack([priors.reshape(-1), np.full(8, 0.1, np.float32)])[None]
    conf = np.asarray([[0.05, 0.9, 0.05, 0.1, 0.1, 0.8]], np.float32)
    t, j = _both(np.zeros((1, 8)), conf, pr)
    head = tnn.DetectionOutputSSD(n_classes=3, conf_thresh=0.3,
                                  nms_thresh=0.45)
    out = _np(head(t))
    ref = np.asarray(jnn.DetectionOutputSSD(n_classes=3, conf_thresh=0.3,
                                            nms_thresh=0.45)(j))
    np.testing.assert_allclose(out, ref, **TOL)
    assert out.shape[:2] == (1, 1) and out.shape[3] == 7
    rows = {int(r[1]): r for r in out[0, 0]}
    assert len(rows) == 2
    np.testing.assert_allclose(rows[1][2], 0.9, rtol=1e-5)
    np.testing.assert_allclose(rows[1][3:], priors[0], atol=1e-5)
    np.testing.assert_allclose(rows[2][3:], priors[1], atol=1e-5)


@pytest.mark.usefixtures("_jax_jitted")
@pytest.mark.parametrize("keep_top_k", [12, -1])
def test_detection_output_ssd_matches_jax_on_priors(keep_top_k):
    """Priors of a 4 x 4 map, random deltas, softmaxed confidences over 4
    classes: the kept rows, their order and values are JAX's, with and
    without the cross-class cut."""
    rs = np.random.RandomState(9)
    kw = dict(min_sizes=[30.0], max_sizes=[60.0], aspect_ratios=[2.0],
              variances=[0.1, 0.1, 0.2, 0.2], img_size=100, step=25.0)
    pr = _np(tnn.PriorBox(**kw)(torch.zeros(1, 1, 4, 4)))
    n = pr.shape[-1] // 4
    logits = rs.randn(n, 4).astype(np.float32) * 2
    conf = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    t, j = _both((0.5 * rs.randn(1, 4 * n)), conf.reshape(1, -1), pr)
    hk = dict(n_classes=4, nms_thresh=0.45, nms_topk=20,
              keep_top_k=keep_top_k, conf_thresh=0.2)
    out = _np(tnn.DetectionOutputSSD(**hk)(t))
    ref = np.asarray(jnn.DetectionOutputSSD(**hk)(j))
    assert out.shape == ref.shape and out.shape[2] > 0
    np.testing.assert_allclose(out, ref, **TOL)


def test_detection_output_ssd_rejects_unshared_location():
    with pytest.raises(NotImplementedError):
        tnn.DetectionOutputSSD(n_classes=3, share_location=False)


# ------------------------------------------------------ DetectionOutputFrcnn
def _frcnn_inputs():
    rois = [[0, 2.0, 2.0, 8.0, 8.0], [0, 2.5, 2.5, 8.5, 8.5],
            [0, 12.0, 12.0, 18.0, 18.0]]
    scores = [[0.05, 0.9, 0.05], [0.10, 0.8, 0.05], [0.05, 0.05, 0.7]]
    return _both([[20.0, 20.0, 1.0, 1.0]], rois, np.zeros((3, 12)), scores)


def _frcnn(**kw):
    head, jhead = tnn.DetectionOutputFrcnn(**kw), jnn.DetectionOutputFrcnn(
        **kw)
    head.evaluate()
    jhead.evaluate()
    return head, jhead


@pytest.mark.usefixtures("_jax_jitted")
def test_detection_output_frcnn_nms_and_layout():
    head, jhead = _frcnn(nms_thresh=0.3, n_classes=3)
    t, j = _frcnn_inputs()
    out = _np(head(t))
    np.testing.assert_allclose(out, np.asarray(jhead(j)), **TOL)
    n = int(out[0, 0])
    assert n == 2
    rows = out[0, 1:1 + n * 6].reshape(n, 6)
    assert set(rows[:, 0].astype(int)) == {1, 2}
    assert rows[:, 1].min() >= 0.05


@pytest.mark.usefixtures("_jax_jitted")
def test_detection_output_frcnn_max_per_image_and_training_passthrough():
    head, jhead = _frcnn(nms_thresh=0.99, n_classes=3, max_per_image=1)
    t, j = _frcnn_inputs()
    out = _np(head(t))
    np.testing.assert_allclose(out, np.asarray(jhead(j)), **TOL)
    assert int(out[0, 0]) == 1
    head.training = True
    assert head(t) is t


@pytest.mark.usefixtures("_jax_jitted")
def test_detection_output_frcnn_bbox_vote():
    head, jhead = _frcnn(nms_thresh=0.3, n_classes=3, bbox_vote=True)
    t, j = _frcnn_inputs()
    out = _np(head(t))
    np.testing.assert_allclose(out, np.asarray(jhead(j)), **TOL)
    n = int(out[0, 0])
    cls1 = out[0, 1:1 + n * 6].reshape(n, 6)
    assert 2.0 < cls1[cls1[:, 0] == 1][0][2] < 2.5


@pytest.mark.usefixtures("_jax_jitted")
@pytest.mark.parametrize("vote", [False, True])
def test_detection_output_frcnn_matches_jax_on_random_rois(vote):
    rs = np.random.RandomState(12)
    n_rois, n_cls, per_class = 40, 4, 12
    rois = np.concatenate([np.zeros((n_rois, 1)),
                           _random_boxes(rs, n_rois, 50.0)], 1)
    # each class scores the same number of rois above the threshold (one
    # JAX nms program for all), at random levels and places
    scores = rs.rand(n_rois, n_cls).astype(np.float32) * 0.1
    for c in range(n_cls):
        scores[rs.choice(n_rois, per_class, replace=False), c] = \
            0.15 + 0.8 * rs.rand(per_class)
    t, j = _both([[72.0, 96.0, 1.2, 1.5]], rois,
                 0.2 * rs.randn(n_rois, 4 * n_cls), scores)
    kw = dict(nms_thresh=0.3, n_classes=n_cls, bbox_vote=vote,
              max_per_image=15, thresh=0.1)
    head, jhead = _frcnn(**kw)
    out = _np(head(t))
    ref = np.asarray(jhead(j))
    assert out.shape == ref.shape and int(out[0, 0]) > 0
    np.testing.assert_allclose(out, ref, **TOL)


# ------------------------------------------- the JAX test's image pipeline
def test_image_frame_pipeline_with_roi_transforms():
    imgs = np.random.RandomState(0).rand(3, 8, 8, 3).astype(np.float32)

    def run(m):
        frame = m.ImageFrame.array(imgs, labels=np.asarray([1, 2, 3]))
        for f in frame:
            f[m.ImageFeature.boxes] = np.asarray([[2.0, 2.0, 6.0, 6.0]])
        out = frame.transform(m.Resize(16, 16)).transform(m.RoiResize())
        flipped = out.transform(m.HFlip()).transform(
            m.RoiHFlip(normalized=False))
        norm = flipped.transform(m.RoiNormalize())
        boxes = [list(x)[0][m.ImageFeature.boxes]
                 for x in (out, flipped, norm)]
        batches = list(m.ImageFeatureToBatch(3)(iter(norm.transform(
            m.ChannelNormalize([0.5, 0.5, 0.5])).features)))
        return boxes, batches

    (boxes, batches), (jboxes, jbatches) = run(vision), run(jvision)
    for b, jb in zip(boxes, jboxes):
        np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(boxes[2], [[0.25, 0.25, 0.75, 0.75]])
    assert len(batches) == len(jbatches) == 1
    assert batches[0].get_input().shape == (3, 3, 16, 16)
    np.testing.assert_array_equal(batches[0].get_input(),
                                  jbatches[0].get_input())
