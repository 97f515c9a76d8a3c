"""Detection heads (port of ``bigdl_tpu/nn/detection.py``): the box math,
``nms`` / ``Nms``, ``PriorBox``, ``Anchor``, ``Proposal``, ``RoiPooling``,
``DetectionOutputSSD`` and ``DetectionOutputFrcnn``.

The JAX package runs ``nms`` as a ``fori_loop`` of k masked steps and the
two output heads on the host. Here every function runs on its input's
device and returns there, and the data-dependent parts are split so that
the number of launches of a call does not grow with the candidates:

- ``nms`` sorts stably (JAX's ``argsort`` is stable), computes the
  candidates' IoU on the device once, copies ``iou > thresh`` to the host
  and scans it greedily there (IoU is bitwise symmetric, so "suppressed
  by an earlier kept box" reads only the kept boxes' rows);
- ``DetectionOutputSSD`` / ``DetectionOutputFrcnn`` decode every box,
  sort every class and compute every class's IoU on the device in one
  batch, then copy what the greedy scans and the output rows need to the
  host in one wait (``_host``);
- ``Proposal`` decodes on the device and, as the JAX layer does, clips,
  drops small boxes and sorts with numpy's default ``argsort`` on the
  host (not stable: the port keeps numpy's call, so ties order as in
  JAX), then suppresses through the device IoU: two waits a call;
- ``RoiPooling`` takes each output cell's max over a window gathered
  from the feature map, in chunks of rois that bound the elements a chunk
  holds (``ROI_CHUNK_ELEMENTS``). JAX's masked max over the whole map
  for every roi and cell would be (R, C, ph, pw, H, W): ~72 GB at Faster
  R-CNN's 300 rois of 512 x 38 x 63. ``amax`` over the window splits a
  cell's gradient equally over every tied maximum in it, as ``jnp.max``
  does (a max over rows, then columns, would not).

Copies to the host go through pinned memory and one
``synchronize`` (a call's host waits are counted by
``torch.cuda.set_sync_debug_mode``); copies to the device are pinned and
non-blocking.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import Table

# elements of one chunk of RoiPooling's work: its rois' maps and windows
# (256 MB in f32)
ROI_CHUNK_ELEMENTS = 1 << 26


def _t(x, device=None) -> torch.Tensor:
    """``x`` as a tensor (host data as float32), on ``device`` if given."""
    if not torch.is_tensor(x):
        a = np.asarray(x)
        x = torch.from_numpy(np.ascontiguousarray(
            a.astype(np.float32) if a.dtype == np.float64 else a))
    return x if device is None else _upload(x, device)


def _upload(x, device) -> torch.Tensor:
    """A host array or tensor on ``device``: pinned and non-blocking for
    the card, so the host does not wait."""
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(
        x, np.ndarray) else x
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """numpy copies of ``tensors``: from the card through pinned buffers
    and one wait for all of them."""
    if not tensors[0].is_cuda:
        return [t.detach().numpy() for t in tensors]
    outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for o, t in zip(outs, tensors):
        o.copy_(t.detach(), non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [o.numpy() for o in outs]


# ------------------------------------------------------------------ box math
def bbox_iou(boxes_a, boxes_b) -> torch.Tensor:
    """IoU matrix (..., Na, Nb) of (x1, y1, x2, y2) boxes (..., N, 4): the
    JAX formula, no ``+1`` in the widths, ``+1e-12`` in the union."""
    a = _t(boxes_a)
    b = _t(boxes_b, a.device)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter
                    + 1e-12)


def decode_boxes(prior_boxes, prior_variances, deltas,
                 variance_encoded_in_target: bool = False,
                 clip: bool = False) -> torch.Tensor:
    """SSD center-size decode (``BboxUtil.decodeBoxes:283``)."""
    d = _t(deltas)
    p = _t(prior_boxes, d.device)
    v = _t(prior_variances, d.device)
    pw = p[:, 2] - p[:, 0]
    ph = p[:, 3] - p[:, 1]
    pcx = (p[:, 0] + p[:, 2]) / 2
    pcy = (p[:, 1] + p[:, 3]) / 2
    if variance_encoded_in_target:
        cx = d[:, 0] * pw + pcx
        cy = d[:, 1] * ph + pcy
        w = torch.exp(d[:, 2]) * pw
        h = torch.exp(d[:, 3]) * ph
    else:
        cx = v[:, 0] * d[:, 0] * pw + pcx
        cy = v[:, 1] * d[:, 1] * ph + pcy
        w = torch.exp(v[:, 2] * d[:, 2]) * pw
        h = torch.exp(v[:, 3] * d[:, 3]) * ph
    out = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=1)
    return out.clamp(0.0, 1.0) if clip else out


def bbox_transform_inv(boxes, deltas) -> torch.Tensor:
    """R-CNN delta application (``BboxUtil.bboxTransformInv``): boxes
    (N, 4), deltas (N, 4k) -> (N, 4k)."""
    d = _t(deltas)
    boxes = _t(boxes, d.device)
    w = boxes[:, 2] - boxes[:, 0] + 1.0
    h = boxes[:, 3] - boxes[:, 1] + 1.0
    cx = boxes[:, 0] + 0.5 * w
    cy = boxes[:, 1] + 0.5 * h
    pcx = d[:, 0::4] * w[:, None] + cx[:, None]
    pcy = d[:, 1::4] * h[:, None] + cy[:, None]
    pw = torch.exp(d[:, 2::4]) * w[:, None]
    ph = torch.exp(d[:, 3::4]) * h[:, None]
    out = torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                       pcx + 0.5 * pw - 1.0, pcy + 0.5 * ph - 1.0], dim=2)
    return out.reshape(boxes.shape[0], -1)


def _clip(x, hi):
    x = x.clamp_min(0.0)
    return torch.minimum(x, hi) if torch.is_tensor(hi) else x.clamp_max(hi)


def clip_boxes(boxes, height, width) -> torch.Tensor:
    """Every (x1, y1, x2, y2) of (N, 4k) boxes into [0, width - 1] x
    [0, height - 1] (``height`` / ``width`` numbers or 0-dim tensors)."""
    boxes = _t(boxes)
    out = torch.stack([_clip(boxes[:, 0::4], width - 1.0),
                       _clip(boxes[:, 1::4], height - 1.0),
                       _clip(boxes[:, 2::4], width - 1.0),
                       _clip(boxes[:, 3::4], height - 1.0)], dim=2)
    return out.reshape(boxes.shape[0], -1)


# ----------------------------------------------------------------------- NMS
def _greedy(sup: np.ndarray) -> np.ndarray:
    """The keep mask of greedy suppression over candidates in score
    order, ``sup[i, j]`` = ``iou(i, j) > thresh``: a candidate survives
    unless an earlier kept one suppresses it."""
    keep = np.ones(sup.shape[0], bool)
    for i in range(sup.shape[0]):
        if keep[i]:
            keep[i + 1:] &= ~sup[i, i + 1:]
    return keep


def _sorted_candidates(scores: torch.Tensor, selected: torch.Tensor, k: int):
    """The first ``k`` indices of each row of ``scores`` (G, P) in
    descending score order, the selected entries first, ties in index
    order (a stable sort of ``-score``, as JAX's ``argsort``)."""
    key = torch.where(selected, -scores,
                      torch.full((), math.inf, dtype=scores.dtype,
                                 device=scores.device))
    return torch.sort(key, dim=-1, stable=True).indices[..., :k]


def nms(scores, boxes, thresh: float, topk: int = 200):
    """Greedy IoU suppression (``nn/Nms.scala:26``) of the ``topk`` best
    of ``scores`` (N,) over ``boxes`` (N, 4): ``(indices, count)`` on the
    scores' device, the first ``count`` of the (k,) int32 ``indices`` the
    kept boxes in score order, the rest -1. The launches of a call do
    not depend on k (one IoU on the device, one copy, a host scan)."""
    scores = _t(scores)
    boxes = _t(boxes, scores.device)
    k = min(topk, scores.shape[0])
    order = _sorted_candidates(scores, torch.ones_like(scores, dtype=bool),
                               k)
    cand = boxes[order]
    sup, order_h = _host(bbox_iou(cand, cand) > thresh, order)
    keep = _greedy(sup)
    count = int(keep.sum())
    compact = np.full(k, -1, np.int32)
    compact[:count] = order_h[keep]
    return (_upload(compact, scores.device),
            _upload(np.asarray(count, np.int32), scores.device))


class Nms:
    """Object facade matching the reference's ``Nms`` class."""

    def __call__(self, scores, boxes, thresh: float, topk: int = 200):
        return nms(scores, boxes, thresh, topk)


# ------------------------------------------------------------------ PriorBox
class PriorBox(Module):
    """SSD prior boxes (``nn/PriorBox.scala:41``). Input: the feature map
    (N, C, layer_h, layer_w), or ``Table(feature map, data)`` whose data
    gives the image size when ``img_h`` / ``img_w`` are not set. Output
    (1, 2, layer_h * layer_w * num_priors * 4) on the feature map's
    device: channel 0 the boxes, channel 1 the variances. The boxes are
    the JAX package's host loop (Python floats, then float32), cached per
    feature and image size and step."""

    def __init__(self, min_sizes: Sequence[float],
                 max_sizes: Optional[Sequence[float]] = None,
                 aspect_ratios: Optional[Sequence[float]] = None,
                 is_flip: bool = True, is_clip: bool = False,
                 variances: Optional[Sequence[float]] = None,
                 offset: float = 0.5, img_h: int = 0, img_w: int = 0,
                 img_size: int = 0, step_h: float = 0.0, step_w: float = 0.0,
                 step: float = 0.0):
        super().__init__()
        self.min_sizes = [float(s) for s in min_sizes]
        self.max_sizes = [float(s) for s in (max_sizes or [])]
        ars = [1.0]
        for ar in (aspect_ratios or []):
            if any(abs(ar - a) < 1e-6 for a in ars):
                continue
            ars.append(float(ar))
            if is_flip:
                ars.append(1.0 / float(ar))
        self.aspect_ratios = ars
        self.is_clip = is_clip
        self.variances = [float(v) for v in (variances or [0.1])]
        self.offset = offset
        self.img_h = img_h or img_size
        self.img_w = img_w or img_size
        self.step_h = step_h or step
        self.step_w = step_w or step
        self.num_priors = (len(self.min_sizes) * len(ars)
                           + len(self.max_sizes))
        self._prior_cache_key = None
        self._prior_cache = None

    def _priors(self, layer_h, layer_w, img_h, img_w, step_h, step_w):
        boxes = []
        for h in range(layer_h):
            for w in range(layer_w):
                cx = (w + self.offset) * step_w
                cy = (h + self.offset) * step_h
                for k, ms in enumerate(self.min_sizes):
                    def push(bw, bh):
                        boxes.append([(cx - bw / 2) / img_w,
                                      (cy - bh / 2) / img_h,
                                      (cx + bw / 2) / img_w,
                                      (cy + bh / 2) / img_h])

                    push(ms, ms)
                    if self.max_sizes:
                        pr = math.sqrt(ms * self.max_sizes[k])
                        push(pr, pr)
                    for ar in self.aspect_ratios:
                        if abs(ar - 1.0) < 1e-6:
                            continue
                        push(ms * math.sqrt(ar), ms / math.sqrt(ar))
        pri = np.asarray(boxes, np.float32)
        if self.is_clip:
            pri = np.clip(pri, 0.0, 1.0)
        n = pri.shape[0]
        if len(self.variances) == 1:
            var = np.full((n, 4), self.variances[0], np.float32)
        else:
            var = np.tile(np.asarray(self.variances, np.float32), (n, 1))
        return np.stack([pri.reshape(-1), var.reshape(-1)])[None]

    def forward(self, input):
        x = input[1] if isinstance(input, Table) else input
        layer_h, layer_w = int(x.shape[-2]), int(x.shape[-1])
        img_h, img_w = self.img_h, self.img_w
        if not img_h or not img_w:
            if isinstance(input, Table) and len(input) > 1:
                data = input[2]
                img_h, img_w = int(data.shape[-2]), int(data.shape[-1])
            else:
                raise ValueError(
                    "PriorBox needs img_h/img_w (or img_size), or a "
                    "Table(featureMap, data) input to derive them from")
        step_h = self.step_h or img_h / layer_h
        step_w = self.step_w or img_w / layer_w
        key = (layer_h, layer_w, img_h, img_w, step_h, step_w, x.device)
        if self._prior_cache_key != key:
            self._prior_cache = _upload(self._priors(*key[:6]), x.device)
            self._prior_cache_key = key
        return self._prior_cache


# -------------------------------------------------------------------- Anchor
class Anchor:
    """RPN anchors (``nn/Anchor.scala``): the 16 x 16 base box scaled and
    reshaped by ratios and scales, shifted over the feature grid (host
    numpy, as in the JAX package)."""

    def __init__(self, ratios: Sequence[float], scales: Sequence[float],
                 base_size: int = 16):
        self.ratios = np.asarray(ratios, np.float32)
        self.scales = np.asarray(scales, np.float32)
        self.base_size = base_size
        self.base_anchors = self._generate_base()
        self.num = len(self.base_anchors)

    def _generate_base(self) -> np.ndarray:
        base = np.asarray([0, 0, self.base_size - 1, self.base_size - 1],
                          np.float32)
        w = base[2] - base[0] + 1
        h = base[3] - base[1] + 1
        cx = base[0] + 0.5 * (w - 1)
        cy = base[1] + 0.5 * (h - 1)
        anchors = []
        size = w * h
        for r in self.ratios:
            ws = np.round(np.sqrt(size / r))
            hs = np.round(ws * r)
            for s in self.scales:
                wss, hss = ws * s, hs * s
                anchors.append([cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1),
                                cx + 0.5 * (wss - 1), cy + 0.5 * (hss - 1)])
        return np.asarray(anchors, np.float32)

    def generate_anchors(self, width: int, height: int,
                         feat_stride: float = 16.0) -> np.ndarray:
        sx = np.arange(width) * feat_stride
        sy = np.arange(height) * feat_stride
        shift_x, shift_y = np.meshgrid(sx, sy)
        shifts = np.stack([shift_x.ravel(), shift_y.ravel(),
                           shift_x.ravel(), shift_y.ravel()], axis=1)
        return (self.base_anchors[None] + shifts[:, None].astype(np.float32)
                ).reshape(-1, 4)


# ------------------------------------------------------------------ Proposal
class Proposal(Module):
    """RPN proposals (``nn/Proposal.scala:34``): Table(scores (1, 2A, H,
    W), deltas (1, 4A, H, W), im_info [h, w, scale, ...]) -> rois (n, 5)
    ``[0, x1, y1, x2, y2]`` on the scores' device: anchors moved by the
    deltas and clipped, boxes under ``min_size * im_info[2]`` dropped, the
    first ``pre_nms_topn`` by score suppressed at ``nms_thresh``, the
    first ``post_nms_topn`` survivors kept (train or test counts by
    mode); (0, 5) when no box is left."""

    def __init__(self, pre_nms_topn: int, post_nms_topn: int,
                 ratios: Sequence[float], scales: Sequence[float],
                 rpn_pre_nms_topn_train: int = 12000,
                 rpn_post_nms_topn_train: int = 2000,
                 min_size: int = 16, feat_stride: float = 16.0,
                 nms_thresh: float = 0.7):
        super().__init__()
        self.pre_nms_topn_test = pre_nms_topn
        self.post_nms_topn_test = post_nms_topn
        self.pre_nms_topn_train = rpn_pre_nms_topn_train
        self.post_nms_topn_train = rpn_post_nms_topn_train
        self.anchor = Anchor(ratios, scales)
        self.min_size = min_size
        self.feat_stride = feat_stride
        self.nms_thresh = nms_thresh

    def forward(self, input):
        scores_all, deltas, im_info = list(input)[:3]
        pre_n = (self.pre_nms_topn_train if self.training
                 else self.pre_nms_topn_test)
        post_n = (self.post_nms_topn_train if self.training
                  else self.post_nms_topn_test)
        scores_all = _t(scores_all)
        dev = scores_all.device
        a = self.anchor.num
        scores = scores_all[0, a:]
        h, w = scores.shape[-2:]
        anchors = self.anchor.generate_anchors(w, h, self.feat_stride)
        d = _t(deltas, dev)[0].reshape(a, 4, h, w).permute(2, 3, 0, 1) \
            .reshape(-1, 4)
        s = scores.reshape(a, h, w).permute(1, 2, 0).reshape(-1)
        boxes = bbox_transform_inv(_upload(anchors, dev), d)
        boxes, s, info = _host(boxes, s, _t(im_info, dev).reshape(-1))
        boxes = np.stack([np.clip(boxes[:, 0], 0, info[1] - 1.0),
                          np.clip(boxes[:, 1], 0, info[0] - 1.0),
                          np.clip(boxes[:, 2], 0, info[1] - 1.0),
                          np.clip(boxes[:, 3], 0, info[0] - 1.0)], axis=1)
        ws = boxes[:, 2] - boxes[:, 0] + 1
        hs = boxes[:, 3] - boxes[:, 1] + 1
        min_sz = self.min_size * (info[2] if info.size > 2 else 1.0)
        valid = (ws >= min_sz) & (hs >= min_sz)
        boxes, s = boxes[valid], s[valid]
        if boxes.shape[0] == 0:
            return torch.zeros((0, 5), dtype=torch.float32, device=dev)
        order = np.argsort(-s)[:pre_n]
        boxes = boxes[order]
        cand = _upload(boxes, dev)
        (sup,) = _host(bbox_iou(cand, cand) > self.nms_thresh)
        kept = boxes[np.flatnonzero(_greedy(sup))[:post_n]]
        rois = np.concatenate(
            [np.zeros((kept.shape[0], 1), np.float32), kept], axis=1)
        return _upload(rois, dev)


# ---------------------------------------------------------------- RoiPooling
class RoiPooling(Module):
    """ROI max pooling (``nn/RoiPooling.scala:42``): Table(features (N, C,
    H, W), rois (R, 5) ``[batch_idx, x1, y1, x2, y2]``) -> (R, C,
    pooled_h, pooled_w). Roi corners scale by ``spatial_scale`` and round
    half to even (``jnp.round``, ``torch.round``); each cell is the max
    of its window, 0 when the window is empty. The windows are gathered in
    chunks of rois (see the module docstring); the window sizes are read
    on the host (one wait a call)."""

    def __init__(self, pooled_w: int, pooled_h: int, spatial_scale: float):
        super().__init__()
        self.pooled_w, self.pooled_h = pooled_w, pooled_h
        self.spatial_scale = spatial_scale

    def _bounds(self, lo, extent, n_bins, limit):
        """(R, n_bins) start and end (exclusive) of each bin's cells."""
        # a device tensor as the divisor: CUDA divides by a host scalar
        # as a product with its reciprocal, which rounds otherwise than
        # JAX's division and moves floor / ceil across an integer
        size = extent / torch.full_like(extent, float(n_bins))
        p = torch.arange(n_bins, dtype=size.dtype, device=size.device)
        start = torch.floor(p[None] * size[:, None]) + lo[:, None]
        end = torch.ceil((p[None] + 1) * size[:, None]) + lo[:, None]
        return (start.clamp(0, limit).to(torch.int64),
                end.clamp(0, limit).to(torch.int64))

    def forward(self, input):
        feats, rois = list(input)[:2]
        feats = _t(feats)
        rois = _t(rois, feats.device).to(torch.float32)
        _, c, height, width = feats.shape
        ph, pw = self.pooled_h, self.pooled_w
        bi = rois[:, 0].to(torch.int64)
        x1, y1, x2, y2 = (torch.round(rois[:, i] * self.spatial_scale)
                          for i in range(1, 5))
        hs, he = self._bounds(y1, (y2 - y1 + 1.0).clamp_min(1.0), ph, height)
        ws, we = self._bounds(x1, (x2 - x1 + 1.0).clamp_min(1.0), pw, width)
        kh, kw = (max(1, v) for v in _host(torch.stack(
            [(he - hs).max(), (we - ws).max()]))[0].tolist()) \
            if rois.shape[0] else (1, 1)
        dev = feats.device
        ar_h = torch.arange(kh, device=dev)
        ar_w = torch.arange(kw, device=dev)
        flat = feats.flatten(2)                            # (N, C, H*W)
        per_roi = c * (height * width + 2 * ph * pw * kh * kw)
        chunk = max(1, ROI_CHUNK_ELEMENTS // per_roi)
        outs = []
        for r0 in range(0, rois.shape[0], chunk):
            sl = slice(r0, r0 + chunk)
            rows = hs[sl, :, None] + ar_h                  # (r, ph, kh)
            cols = ws[sl, :, None] + ar_w                  # (r, pw, kw)
            mask = ((rows < he[sl, :, None])[:, :, None, :, None]
                    & (cols < we[sl, :, None])[:, None, :, None, :])
            at = (rows.clamp_max(height - 1)[:, :, None, :, None] * width
                  + cols.clamp_max(width - 1)[:, None, :, None, :])
            r = at.shape[0]
            # the window's cells of every channel: a gather of the rois'
            # maps by one (r, 1, cells) index broadcast over the channels
            win = flat.index_select(0, bi[sl]).gather(
                2, at.reshape(r, 1, -1).expand(-1, c, -1)).reshape(
                r, c, ph, pw, kh, kw)
            win = torch.where(mask[:, None], win, torch.full(
                (), -math.inf, dtype=win.dtype, device=dev))
            empty = ~mask.any(dim=-1).any(dim=-1)[:, None]
            outs.append(torch.where(empty, torch.zeros((), dtype=win.dtype,
                                                       device=dev),
                                    win.amax(dim=(-2, -1))))
        if not outs:
            return feats.new_zeros((0, c, ph, pw))
        return torch.cat(outs)


# -------------------------------------------------------- DetectionOutputSSD
class DetectionOutputSSD(Module):
    """SSD inference head (``nn/DetectionOutputSSD.scala:301``):
    Table(loc (1, P*4), conf (1, P*n_classes), priors (1, 2, P*4)) ->
    (1, 1, n, 7) rows ``[0, label, score, x1, y1, x2, y2]`` on loc's
    device. Per class: scores above ``conf_thresh``, NMS of the best
    ``nms_topk``; then the best ``keep_top_k`` over all classes by a
    stable sort (ties stay in class, then NMS order). Decode, sorts and
    IoUs run on the device for every class at once, and reach the host
    in one copy."""

    def __init__(self, n_classes: int = 21, share_location: bool = True,
                 bg_label: int = 0, nms_thresh: float = 0.45,
                 nms_topk: int = 400, keep_top_k: int = 200,
                 conf_thresh: float = 0.01,
                 variance_encoded_in_target: bool = False):
        super().__init__()
        if not share_location:
            raise NotImplementedError(
                "per-class location predictions (share_location=False) are "
                "not supported; the SSD zoo models all share locations")
        self.n_classes = n_classes
        self.share_location = share_location
        self.bg_label = bg_label
        self.nms_thresh = nms_thresh
        self.nms_topk = nms_topk
        self.keep_top_k = keep_top_k
        self.conf_thresh = conf_thresh
        self.variance_encoded_in_target = variance_encoded_in_target

    def forward(self, input):
        loc, conf, priors = list(input)[:3]
        loc = _t(loc).reshape(-1, 4)
        dev = loc.device
        n_priors = loc.shape[0]
        pr = _t(priors, dev)
        decoded = decode_boxes(pr[0, 0].reshape(-1, 4)[:n_priors],
                               pr[0, 1].reshape(-1, 4)[:n_priors], loc,
                               self.variance_encoded_in_target, clip=True)
        classes = [c for c in range(self.n_classes) if c != self.bg_label]
        sc = _t(conf, dev).reshape(n_priors, self.n_classes).t() \
            .index_select(0, _upload(np.asarray(classes, np.int64), dev))
        sel = sc > self.conf_thresh
        order = _sorted_candidates(sc, sel, min(self.nms_topk, n_priors))
        cand = decoded[order]
        sup, n_sel, top, boxes = _host(
            bbox_iou(cand, cand) > self.nms_thresh, sel.sum(dim=1),
            sc.gather(1, order), cand)
        results = []
        for g, cls in enumerate(classes):
            k = min(order.shape[1], int(n_sel[g]))
            for i in np.flatnonzero(_greedy(sup[g, :k, :k])):
                results.append([0.0, float(cls), float(top[g, i])]
                               + boxes[g, i].tolist())
        if self.keep_top_k > 0 and len(results) > self.keep_top_k:
            results.sort(key=lambda r: -r[2])
            results = results[:self.keep_top_k]
        if not results:
            return torch.zeros((1, 1, 0, 7), dtype=torch.float32, device=dev)
        return _upload(np.asarray(results, np.float32)[None, None], dev)


# ------------------------------------------------------- DetectionOutputFrcnn
def _iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``bbox_iou`` in float32 numpy (the host's share of ``bbox_vote``)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, np.float32(0.0))
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter
                    + np.float32(1e-12))


class DetectionOutputFrcnn(Module):
    """Faster R-CNN inference head (``nn/DetectionOutputFrcnn.scala:48``):
    Table(im_info (1, 4) [h, w, scale_h, scale_w], rois (R, 5), box
    deltas (R, n_classes*4), scores (R, n_classes)) -> the flat (1, 1 +
    6n) layout ``[n, (class, score, x1, y1, x2, y2) * n]`` on the scores'
    device. Rois are unscaled to the raw image, moved by each class's
    deltas and clipped; per class, scores above ``thresh`` go through NMS;
    ``max_per_image`` keeps the scores at or above the
    ``max_per_image``-th best. ``bbox_vote`` replaces each kept box by the
    score-weighted mean of its class's candidates with IoU >= 0.5. In
    training mode the input object itself is returned. One wait a
    call."""

    def __init__(self, nms_thresh: float = 0.3, n_classes: int = 21,
                 bbox_vote: bool = False, max_per_image: int = 100,
                 thresh: float = 0.05):
        super().__init__()
        self.nms_thresh = nms_thresh
        self.n_classes = n_classes
        self.bbox_vote = bbox_vote
        self.max_per_image = max_per_image
        self.thresh = thresh

    def forward(self, input):
        if self.training:
            return input
        im_info, rois_data, box_deltas, scores = list(input)[:4]
        if isinstance(rois_data, Table):
            rois_data = list(rois_data)[0]
        scores = _t(scores)
        dev = scores.device
        info = _t(im_info, dev).reshape(-1).to(torch.float32)
        scale = torch.stack([1 / info[3], 1 / info[2], 1 / info[3],
                             1 / info[2]])
        boxes = _t(rois_data, dev)[:, 1:5] * scale
        pred = clip_boxes(bbox_transform_inv(boxes, _t(box_deltas, dev)),
                          info[0] / info[2], info[1] / info[3])
        n_rois = scores.shape[0]
        sc = scores.t()[1:]
        sel = sc > self.thresh
        order = _sorted_candidates(sc, sel, n_rois)
        cand = pred.reshape(n_rois, self.n_classes, 4).transpose(0, 1)[1:] \
            .gather(1, order[..., None].expand(-1, -1, 4))
        sup, n_sel, order, top, cand = _host(
            bbox_iou(cand, cand) > self.nms_thresh, sel.sum(dim=1), order,
            sc.gather(1, order), cand)

        per_class = {}
        for g in range(self.n_classes - 1):
            k = int(n_sel[g])
            if k == 0:
                continue
            keep = np.flatnonzero(_greedy(sup[g, :k, :k]))
            kept_boxes = cand[g, keep]
            if self.bbox_vote:
                by_index = np.argsort(order[g, :k], kind="stable")
                kept_boxes = self._vote(kept_boxes, top[g, by_index],
                                        cand[g, by_index])
            per_class[g + 1] = (top[g, keep], kept_boxes)

        if self.max_per_image > 0:
            all_scores = np.concatenate(
                [s for s, _ in per_class.values()]
                or [np.zeros((0,), np.float32)])
            if all_scores.size > self.max_per_image:
                cutoff = np.sort(all_scores)[-self.max_per_image]
                per_class = {
                    c: (s[s >= cutoff], b[s >= cutoff])
                    for c, (s, b) in per_class.items()}

        rows = []
        for cls in sorted(per_class):
            s, b = per_class[cls]
            for j in range(s.shape[0]):
                rows.append([float(cls), float(s[j])] + b[j].tolist())
        flat = [float(len(rows))] + [v for r in rows for v in r]
        return _upload(np.asarray(flat, np.float32)[None], dev)

    @staticmethod
    def _vote(kept_boxes, all_scores, all_boxes):
        iou = _iou_np(kept_boxes, all_boxes)
        out = np.empty_like(kept_boxes)
        for i in range(kept_boxes.shape[0]):
            m = iou[i] >= 0.5
            w = all_scores[m]
            out[i] = (w[:, None] * all_boxes[m]).sum(0) / max(w.sum(), 1e-12)
        return out
