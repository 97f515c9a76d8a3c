"""The port's telemetry (bigdl_tpu_torch/observability) case for case with
tests/test_observability.py: registry semantics, span tracing,
Prometheus rendering, the /metrics endpoint against a live
GenerationService, the Optimizer integration; then the schema test (every
``bdt_`` instrument is the JAX one of the same kind, labels and buckets),
the process-global switches, and the span's ``record_function`` under a
profiler capture."""

import json
import re
import threading
import urllib.request

import jax
import numpy as np
import pytest

import torch

from bigdl_tpu import observability as jobs
from bigdl_tpu_torch import observability as obs


@pytest.fixture()
def reg():
    """A fresh registry installed as the process default for the test
    (integrations resolve the default at use time); the previous default
    and the switches are restored."""
    r = obs.MetricRegistry()
    prev = obs.set_default_registry(r)
    try:
        yield r
    finally:
        obs.set_default_registry(prev)
        obs.enable()


# ----------------------------------------------------------------- registry
class TestRegistry:
    def test_counter_gauge_basics(self, reg):
        c = reg.counter("req_total", "requests")
        c.inc()
        c.inc(2.5)
        assert c.get() == 3.5
        with pytest.raises(ValueError, match="only go up"):
            c.inc(-1)
        g = reg.gauge("temp", "gauge")
        g.set(4.0)
        g.inc()
        g.dec(2)
        assert g.get() == 3.0

    def test_get_or_create_and_type_mismatch(self, reg):
        a = reg.counter("x_total", "x")
        assert reg.counter("x_total") is a
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("x_total")
        with pytest.raises(ValueError, match="labels"):
            reg.counter("x_total", labelnames=("a",))
        with pytest.raises(ValueError, match="invalid metric name"):
            reg.counter("bad name")

    def test_labels_children_are_independent(self, reg):
        fam = reg.counter("svc_total", "per-service", labelnames=("svc",))
        fam.labels("a").inc(2)
        fam.labels(svc="b").inc(5)
        assert fam.labels("a") is fam.labels("a")
        assert fam.labels("a").get() == 2
        assert fam.labels("b").get() == 5
        with pytest.raises(ValueError, match="label"):
            fam.labels("a", "b")
        with pytest.raises(ValueError, match="labels"):
            fam.inc()  # labeled family has no anonymous child

    def test_name_validation_prometheus_charset(self, reg):
        with pytest.raises(ValueError, match="invalid metric name"):
            reg.counter("9starts_with_digit")
        with pytest.raises(ValueError, match="invalid label name"):
            reg.gauge("ok", labelnames=("a:b",))
        reg.counter("ns:ok_total")  # ':' is legal in METRIC names

    def test_histogram_bucket_mismatch_raises(self, reg):
        reg.histogram("hb_seconds", "h", buckets=(0.001, 0.01))
        reg.histogram("hb_seconds", "h")  # buckets=None: don't-care
        with pytest.raises(ValueError, match="buckets"):
            reg.histogram("hb_seconds", "h", buckets=(1.0, 10.0))

    def test_gauge_track_survives_mid_flight_toggle(self, reg):
        g = reg.gauge("inflight", "g")
        with g.track():
            assert g.get() == 1
            reg.disable()
        # exit mirrored the ENTRY decision: back to 0, not stuck at 1
        reg.enable()
        assert g.get() == 0
        reg.disable()
        with g.track():
            reg.enable()
        assert g.get() == 0  # and the reverse toggle never goes to -1

    def test_histogram_buckets_cumulative(self, reg):
        h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0, 5.0))
        for v in (0.05, 0.5, 0.7, 3.0, 100.0):
            h.observe(v)
        cum, total, count = h.get()
        assert cum == [1, 3, 4, 5]  # cumulative incl. +Inf
        assert count == 5 and total == pytest.approx(104.25)
        with pytest.raises(ValueError, match="sorted"):
            reg.histogram("bad_h", buckets=(1.0, 0.5))

    def test_histogram_timer(self, reg):
        h = reg.histogram("t_seconds", "t")
        with h.time():
            pass
        _, total, count = h.get()
        assert count == 1 and total >= 0

    def test_concurrent_increments_are_exact(self, reg):
        c = reg.counter("n_total", "n")
        h = reg.histogram("hc", "h", buckets=(10.0,))

        def work():
            for _ in range(1000):
                c.inc()
                h.observe(1.0)

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert c.get() == 8000
        assert h.get()[2] == 8000

    def test_disabled_registry_is_noop(self, reg):
        c = reg.counter("c_total", "c")
        h = reg.histogram("h_seconds", "h")
        reg.disable()
        c.inc(100)
        h.observe(1.0)
        assert c.get() == 0 and h.get()[2] == 0
        reg.enable()
        c.inc()
        assert c.get() == 1


# ------------------------------------------------------------------ tracing
class TestTracing:
    def test_span_nesting_builds_tree(self):
        tr = obs.Tracer()
        with tr.span("outer"):
            with tr.span("inner_a"):
                pass
            with tr.span("inner_b"):
                with tr.span("leaf"):
                    pass
        roots = tr.roots()
        assert [r.name for r in roots] == ["outer"]
        outer = roots[0]
        assert [c.name for c in outer.children] == ["inner_a", "inner_b"]
        assert outer.children[1].children[0].name == "leaf"
        assert outer.duration >= sum(c.duration for c in outer.children)
        assert "outer" in tr.render() and "leaf" in tr.render()

    def test_threads_get_their_own_stacks(self):
        tr = obs.Tracer()
        done = threading.Event()

        def worker():
            with tr.span("worker_root"):
                with tr.span("worker_child"):
                    done.wait(5)

        t = threading.Thread(target=worker)
        with tr.span("main_root"):
            t.start()
            done.set()
            t.join()
        names = {r.name for r in tr.roots()}
        # the worker's span is a ROOT of its own thread's trace, never a
        # child of the main thread's open span
        assert names == {"main_root", "worker_root"}
        main = tr.roots(name="main_root")[0]
        assert [c.name for c in main.children] == []

    def test_span_feeds_histogram_and_disable(self, reg):
        h = reg.histogram("span_seconds", "s")
        tr = obs.Tracer()
        with tr.span("x", histogram=h):
            pass
        assert h.get()[2] == 1
        tr.disable()
        # a disabled TRACER stops recording spans but must not silence
        # the caller's METRIC (the registry has its own disable switch)
        with tr.span("y", histogram=h):
            pass
        assert h.get()[2] == 2 and tr.roots(name="y") == []


# --------------------------------------------------------------- exporters
GOLDEN = """\
# HELP demo_requests_total requests served
# TYPE demo_requests_total counter
demo_requests_total{service="gen"} 3
# HELP demo_queue_depth queue depth
# TYPE demo_queue_depth gauge
demo_queue_depth 2.5
# HELP demo_wait_seconds wait time
# TYPE demo_wait_seconds histogram
demo_wait_seconds_bucket{le="0.1"} 1
demo_wait_seconds_bucket{le="1"} 2
demo_wait_seconds_bucket{le="+Inf"} 3
demo_wait_seconds_sum 3.55
demo_wait_seconds_count 3
"""


def test_prometheus_text_golden(reg):
    """The golden text, and byte for byte the JAX exporter's text of the
    same registry contents."""
    jreg = jobs.MetricRegistry()
    for r in (reg, jreg):
        r.counter("demo_requests_total", "requests served",
                  labelnames=("service",)).labels("gen").inc(3)
        r.gauge("demo_queue_depth", "queue depth").set(2.5)
        h = r.histogram("demo_wait_seconds", "wait time",
                        buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 3.0):
            h.observe(v)
    assert obs.render_prometheus(reg) == GOLDEN
    assert jobs.render_prometheus(jreg) == GOLDEN


def test_label_escaping(reg):
    reg.gauge("esc", "e", labelnames=("v",)).labels('a"b\\c\nd').set(1)
    line = [l for l in obs.render_prometheus(reg).splitlines()
            if l.startswith("esc{")][0]
    assert line == 'esc{v="a\\"b\\\\c\\nd"} 1'


def _unescape_label(s: str) -> str:
    """Decode a label value per the exposition format (the scraper's
    side of the contract: \\\\ -> \\, \\" -> ", \\n -> newline)."""
    out, i = [], 0
    while i < len(s):
        c = s[i]
        if c == "\\":
            nxt = s[i + 1]  # a trailing lone backslash would be a bug
            out.append({"\\": "\\", '"': '"', "n": "\n"}[nxt])
            i += 2
        else:
            assert c not in ('"', "\n"), \
                f"raw {c!r} must never appear inside a label value"
            out.append(c)
            i += 1
    return "".join(out)


def test_label_escaping_hostile_values_roundtrip(reg):
    """Regression: every exposition-format special (backslash,
    double-quote, line feed) survives a render → parse round-trip,
    including the adversarial literal-backslash-then-n sequence that
    naive escapers turn into a newline, on gauges AND on histogram
    bucket lines (where the hostile value shares the label set with
    ``le``)."""
    hostiles = [
        'plain',
        'he said "hi"',
        'back\\slash',
        'line\nfeed',
        'literal\\nbackslash-n',
        'trailing\\',
        '\\"\n mixed \n"\\',
    ]
    g = reg.gauge("esc_hostile", "g", labelnames=("v",))
    for i, v in enumerate(hostiles):
        g.labels(v).set(i)
    h = reg.histogram("esc_hostile_hist", "h", labelnames=("v",),
                      buckets=(0.1, 1.0))
    h.labels(hostiles[-1]).observe(0.5)
    text = obs.render_prometheus(reg)

    label_re = re.compile(r'\{v="((?:[^"\\]|\\.)*)"')
    seen = []
    for line in text.splitlines():
        if line.startswith("esc_hostile{"):
            m = label_re.match(line[len("esc_hostile"):])
            assert m, f"unparseable label set in {line!r}"
            seen.append(_unescape_label(m.group(1)))
    assert sorted(seen) == sorted(hostiles)  # children render sorted
    # each physical line is one sample: a raw newline inside a value
    # would have split it and broken the value column
    for line in text.splitlines():
        if line.startswith("esc_hostile{"):
            assert line.rsplit(" ", 1)[1] in {str(i) for i in
                                              range(len(hostiles))}
    # histogram bucket lines keep (v, le) both parseable
    bucket_lines = [l for l in text.splitlines()
                    if l.startswith("esc_hostile_hist_bucket")]
    assert len(bucket_lines) == 3  # 0.1, 1.0, +Inf
    for line in bucket_lines:
        m = label_re.match(line[len("esc_hostile_hist_bucket"):])
        assert _unescape_label(m.group(1)) == hostiles[-1]
        assert ',le="' in line
    # HELP lines escape backslash + newline too
    reg.gauge("esc_help", "help with\nnewline and \\ backslash").set(1)
    help_line = [l for l in obs.render_prometheus(reg).splitlines()
                 if l.startswith("# HELP esc_help")][0]
    assert help_line == ("# HELP esc_help help with\\nnewline and "
                         "\\\\ backslash")


def test_percentile_summary_single_and_none_samples():
    """Regression for the freshly-constructed-engine path: one sample
    and all-None samples must summarize, never raise."""
    from bigdl_tpu.observability import percentile_summary as jps
    from bigdl_tpu_torch.observability import percentile_summary

    s = percentile_summary([0.25])
    assert s == jps([0.25])
    xs = list(np.random.RandomState(0).rand(37)) + [None]
    assert percentile_summary(xs) == jps(xs)
    assert s == {"count": 1, "mean": 0.25, "p50": 0.25, "p90": 0.25,
                 "p99": 0.25}
    s = percentile_summary([None, None])
    assert s["count"] == 0
    assert s["mean"] is s["p50"] is s["p90"] is s["p99"] is None
    assert percentile_summary(iter([]))["count"] == 0


def test_write_prometheus_snapshot(reg, tmp_path):
    reg.counter("snap_total", "s").inc(7)
    path = str(tmp_path / "metrics.prom")
    text = obs.write_prometheus(path, reg)
    with open(path) as f:
        assert f.read() == text
    assert "snap_total 7" in text


def test_tensorboard_bridge(reg):
    reg.counter("b_total", "b").inc(4)
    reg.gauge("b_g", "g", labelnames=("k",)).labels("v").set(1.5)
    h = reg.histogram("b_h", "h", buckets=(1.0,))
    h.observe(0.5)
    h.observe(2.0)
    seen = []

    class Writer:
        def add_scalar(self, tag, value, step):
            seen.append((tag, value, step))

    obs.TensorBoardBridge(Writer(), registry=reg).publish(step=7)
    d = {t: v for t, v, _ in seen}
    assert d["b_total"] == 4
    assert d['b_g{k="v"}'] == 1.5
    assert d["b_h_count"] == 2 and d["b_h_sum"] == 2.5
    assert d["b_h_mean"] == pytest.approx(1.25)
    assert all(s == 7 for _, _, s in seen)


def test_http_endpoint_and_healthz(reg):
    reg.counter("httpd_total", "h").inc()
    healthy = {"ok": True}
    with obs.start_http_server(registry=reg, host="127.0.0.1",
                               healthz=lambda: healthy["ok"]) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        resp = urllib.request.urlopen(f"{base}/metrics")
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith("text/plain")
        assert "httpd_total 1" in resp.read().decode()
        hz = urllib.request.urlopen(f"{base}/healthz")
        assert json.loads(hz.read())["status"] == "ok"
        healthy["ok"] = False
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/healthz")
        assert ei.value.code == 503
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/nope")


# ----------------------------------------------------- service integration
def _lms(seed=5):
    """The JAX LM and the port's on its weights (CPU)."""
    from bigdl_tpu.models.transformer import TransformerLM as JaxLM
    from bigdl_tpu.utils import random as rnd
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.utils.weights import load_jax_params

    rnd.set_seed(seed)
    jm = JaxLM(32, embed_dim=16, num_heads=4, num_kv_heads=2, num_layers=2,
               max_len=48, use_rope=True)
    jm.evaluate()
    tm = TransformerLM(32, embed_dim=16, num_heads=4, num_kv_heads=2,
                       num_layers=2, max_len=48, use_rope=True,
                       device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    tm.evaluate()
    return jm, tm


def _parse_prometheus(body: str) -> dict:
    """``{series: value}`` of Prometheus text; every sample line must be
    ``name{labels} value``."""
    out = {}
    for line in body.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def test_metrics_endpoint_roundtrip_live_generation_service(reg):
    """Scrape /metrics off a live port GenerationService: valid
    Prometheus text with the batch-occupancy histogram and tokens/sec,
    the same series (under ``bdt_``) and counts as the JAX service's
    scrape of the same requests, rows equal."""
    from bigdl_tpu.optim import GenerationService as JaxService
    from bigdl_tpu_torch.optim import GenerationService

    jm, tm = _lms()
    r = np.random.RandomState(3)
    reqs = [(r.randint(0, 32, (5,)), 6) for _ in range(4)]
    jreg = jobs.MetricRegistry()
    bodies, rows = [], []
    for svc, render in (
            (GenerationService(tm, max_batch=4, batch_timeout_ms=50.0,
                               bucket_tokens=8),
             lambda: urllib.request.urlopen(
                 f"http://127.0.0.1:{srv.port}/metrics").read().decode()),
            (JaxService(jm, max_batch=4, batch_timeout_ms=50.0,
                        bucket_tokens=8, registry=jreg),
             lambda: jobs.render_prometheus(jreg))):
        out = [None] * len(reqs)
        threads = [threading.Thread(
            target=lambda i=i, p=p, n=n: out.__setitem__(
                i, svc.generate(p, n))) for i, (p, n) in enumerate(reqs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert all(o is not None for o in out)
        rows.append(out)
        with obs.start_http_server(registry=reg, host="127.0.0.1") as srv:
            bodies.append(render())
    for a, b in zip(*rows):
        np.testing.assert_array_equal(a, b)
    body = bodies[0]
    assert ('bdt_serve_batch_occupancy_bucket{service="generation",'
            'le="+Inf"}') in body
    assert 'bdt_generation_tokens_total{service="generation"} 24' \
        in body  # 4 requests x 6
    assert "bdt_generation_tokens_per_sec" in body
    assert 'bdt_serve_requests_total{service="generation"} 4' in body
    assert 'bdt_serve_queue_wait_seconds_count{service="generation"}' \
        in body
    ours, theirs = _parse_prometheus(body), _parse_prometheus(bodies[1])
    for key in ('serve_requests_total{service="generation"}',
                'generation_tokens_total{service="generation"}',
                'serve_queue_wait_seconds_count{service="generation"}',
                'serve_errors_total{service="generation"}'):
        assert ours["bdt_" + key] == theirs["bigdl_" + key], key
    assert {k.replace("bdt_", "", 1).split("{")[0] for k in ours} == \
        {k.replace("bigdl_", "", 1).split("{")[0] for k in theirs}
    s = svc.stats()
    assert s["served"] == 4
    assert s["served"] / s["dispatches"] == pytest.approx(
        s["mean_batch_occupancy"], abs=5e-4)


def test_prediction_service_telemetry(reg):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim.prediction_service import PredictionService

    m = nn.Sequential(nn.Linear(4, 2, device="cpu"))
    svc = PredictionService(m, num_threads=2, max_batch=4,
                            batch_timeout_ms=20.0)
    xs = [np.random.RandomState(i).randn(4).astype(np.float32)
          for i in range(4)]
    outs = [None] * 4
    threads = [threading.Thread(
        target=lambda i=i: outs.__setitem__(i, svc.predict(xs[i])))
        for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert all(o is not None and o.shape == (2,) for o in outs)
    text = obs.render_prometheus(reg)
    assert 'bdt_serve_requests_total{service="prediction"} 4' in text
    assert 'bdt_serve_dispatch_seconds_count{service="prediction"}' \
        in text
    s = svc.stats()
    assert s["served"] == 4 and s["dispatches"] >= 1
    series = _parse_prometheus(text)
    assert series['bdt_serve_dispatches_total{service="prediction"}'] \
        == s["dispatches"]


# ----------------------------------------------------- optimizer integration
def _samples(seed, n):
    from bigdl_tpu_torch.dataset.sample import Sample

    rng = np.random.RandomState(seed)
    return [Sample(rng.randn(4).astype(np.float32),
                   rng.randn(2).astype(np.float32)) for _ in range(n)]


def test_optimizer_smoke_populates_training_metrics(reg):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

    m = nn.Sequential(nn.Linear(4, 2, device="cpu"))
    opt = Optimizer(model=m, dataset=_samples(0, 32),
                    criterion=nn.MSECriterion(), batch_size=8,
                    end_when=Trigger.max_epoch(2))
    opt.set_optim_method(SGD(learning_rate=0.05))
    obs.trace.reset()
    opt.optimize()

    assert reg.get("bdt_train_step_seconds").get()[2] == 8  # 2 epochs x 4
    assert reg.get("bdt_train_records_total").get() == 64
    assert reg.get("bdt_train_loss").get() > 0
    assert reg.get("bdt_train_learning_rate").get() == \
        pytest.approx(0.05)
    assert reg.get("bdt_train_grad_norm").get() > 0
    # one batch shape: one step signature
    assert reg.get("bdt_train_jit_compiles").get() == 1
    assert reg.get("bdt_train_throughput_records_per_sec").get() > 0
    assert len(obs.trace.roots(name="train/step")) == 8
    text = obs.render_prometheus(reg)
    assert "# TYPE bdt_train_step_seconds histogram" in text


def test_optimizer_disabled_observability_takes_plain_step(reg,
                                                           monkeypatch):
    """A disabled registry takes the plain step: no series, and the grad
    norm is never computed (``step_with_stats`` is not called)."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.optim.optimizer import TrainStep

    def refuse(*a, **k):
        raise AssertionError("the stats step ran with observability off")

    monkeypatch.setattr(TrainStep, "step_with_stats", refuse)
    m = nn.Sequential(nn.Linear(4, 2, device="cpu"))
    opt = Optimizer(model=m, dataset=_samples(1, 16),
                    criterion=nn.MSECriterion(), batch_size=8,
                    end_when=Trigger.max_epoch(1))
    opt.set_optim_method(SGD(learning_rate=0.05))
    obs.disable()
    try:
        opt.optimize()
    finally:
        obs.enable()
    step = reg.get("bdt_train_step_seconds")
    assert step is None or step.get()[2] == 0


def test_optimizer_loss_and_grad_norm_match_jax(reg):
    """The port's train loop reports the JAX loop's loss, learning rate
    and pre-clip grad norm for the same model, data and SGD (f32,
    rtol 1e-5)."""
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.dataset.sample import Sample as JaxSample
    from bigdl_tpu.optim import Optimizer as JaxOptimizer
    from bigdl_tpu.optim import SGD as JaxSGD
    from bigdl_tpu.optim import Trigger as JaxTrigger
    from bigdl_tpu.utils import random as rnd
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.utils.weights import load_jax_params

    rnd.set_seed(3)
    jm = jnn.Sequential(jnn.Linear(4, 2))
    tm = nn.Sequential(nn.Linear(4, 2, device="cpu"))
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    samples = _samples(2, 8)
    jreg = jobs.MetricRegistry()
    jprev = jobs.set_default_registry(jreg)
    try:
        jopt = JaxOptimizer(model=jm, dataset=[JaxSample(s.feature(),
                                                         s.label())
                                               for s in samples],
                            criterion=jnn.MSECriterion(), batch_size=8,
                            end_when=JaxTrigger.max_iteration(1))
        jopt.set_optim_method(JaxSGD(learning_rate=0.05))
        jopt.optimize()
    finally:
        jobs.set_default_registry(jprev)
    opt = Optimizer(model=tm, dataset=samples, criterion=nn.MSECriterion(),
                    batch_size=8, end_when=Trigger.max_iteration(1))
    opt.set_optim_method(SGD(learning_rate=0.05))
    opt.optimize()
    for name in ("train_loss", "train_grad_norm", "train_learning_rate",
                 "train_records_total", "train_epoch"):
        assert reg.get("bdt_" + name).get() == pytest.approx(
            jreg.get("bigdl_" + name).get(), rel=1e-5), name


# ------------------------------------------------------------ the schema
#: the families the port mints, by their helper's name
_FAMILIES = ("train_instruments", "parallel_instruments",
             "serving_instruments", "generation_instruments",
             "serving_engine_instruments", "tenant_usage_instruments",
             "qos_instruments", "memory_instruments",
             "watchdog_instruments", "incident_instruments",
             "engine_instruments", "fleet_instruments")


def _schema(mod, prefix):
    """``{name without its head: (kind, labels, buckets)}`` of every
    instrument the package's families register, and the raw names."""
    from importlib import import_module

    metrics = import_module(mod.__name__.rsplit(".", 1)[0] + ".metrics")
    reg = metrics.MetricRegistry()
    for fam in _FAMILIES:
        fn = getattr(mod, fam)
        if fam in ("serving_instruments", "generation_instruments",
                   "serving_engine_instruments", "fleet_instruments"):
            fn("svc", reg)
        else:
            fn(reg)
    out, names = {}, []
    for m in reg.collect():
        names.append(m.name)
        out[m.name[len(prefix):]] = (m.type, m.labelnames,
                                     getattr(m, "buckets", None))
    return out, names


def test_bdt_schema_maps_to_the_jax_schema():
    """The port's one schema, held by this test rather than by the
    OBS001 regex: every instrument the port's families register is named
    ``bdt_<x>`` and the JAX package registers ``bigdl_<x>`` with the same
    kind, label names and buckets, family for family; the buckets
    constants are the JAX ones."""
    from bigdl_tpu.observability import instruments as jins
    from bigdl_tpu_torch.observability import instruments as tins

    ours, names = _schema(tins, "bdt_")
    theirs, _ = _schema(jins, "bigdl_")
    assert names and all(n.startswith("bdt_") for n in names)
    assert ours == theirs
    assert (tins.TIME_BUCKETS, tins.OCCUPANCY_BUCKETS,
            tins.FRACTION_BUCKETS) == (jins.TIME_BUCKETS,
                                       jins.OCCUPANCY_BUCKETS,
                                       jins.FRACTION_BUCKETS)
    # the fleet's families are minted, bdt_fleet_* to bigdl_fleet_*
    fleet = sorted(n for n in ours if n.startswith("fleet_"))
    assert fleet == sorted(n for n in theirs if n.startswith("fleet_"))
    assert {"fleet_replicas_live", "fleet_replicas_draining",
            "fleet_requests_total", "fleet_routed_total",
            "fleet_rerouted_total", "fleet_drains_total",
            "fleet_client_disconnects_total", "fleet_rpc_timeouts_total",
            "fleet_clock_offset_seconds", "fleet_replica_queue_depth",
            "fleet_replica_active_slots", "fleet_hop_seconds",
            "fleet_rejoins_total", "fleet_capacity_headroom",
            "fleet_capacity_replicas_needed"} == set(fleet)
    # the families waiting for the benchmark are not minted
    for fam in ("bench_instruments", "serving_bench_instruments"):
        assert not hasattr(tins, fam)


def test_port_registers_no_bigdl_name_by_any_route(reg):
    """OBS001's rule for the port: no registration call in the package
    takes a ``bigdl_`` literal (the checker's own lint over the package
    tree), and after serving, scoring and training on the CPU every name
    in the registry is a ``bdt_`` name."""
    import os

    from bigdl_tpu.tools.graftlint.checkers import observability_drift
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.optim.prediction_service import PredictionService
    from bigdl_tpu_torch.serving import ContinuousBatchingEngine

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "bigdl_tpu_torch")
    assert list(observability_drift.lint(pkg)) == []
    _, tm = _lms()
    with ContinuousBatchingEngine(tm, max_slots=2, prefill_chunk=4) as eng:
        eng.submit(np.arange(1, 7), 3).result(timeout=60)
    PredictionService(nn.Sequential(nn.Linear(4, 2, device="cpu"))
                      ).predict(np.zeros((1, 4), np.float32))
    opt = Optimizer(model=nn.Sequential(nn.Linear(4, 2, device="cpu")),
                    dataset=_samples(4, 8), criterion=nn.MSECriterion(),
                    batch_size=8, end_when=Trigger.max_iteration(1))
    opt.set_optim_method(SGD(learning_rate=0.05))
    opt.optimize()
    names = [m.name for m in reg.collect()]
    assert len(names) > 40
    assert all(n.startswith("bdt_") for n in names), \
        [n for n in names if not n.startswith("bdt_")]


# ------------------------------------------------------ process globals
def test_enable_disable_switch_every_default_and_restore(reg):
    """``disable()`` switches the default registry, tracer and recorder
    off together and ``enable()`` on; the fixture restores them, so the
    next test starts enabled."""
    rec = obs.default_recorder()
    assert obs.enabled() and obs.trace.enabled and rec.enabled
    obs.disable()
    assert not obs.enabled()
    assert not obs.trace.enabled and not rec.enabled
    c = reg.counter("off_total", "c")
    c.inc()
    assert c.get() == 0
    obs.enable()
    assert obs.enabled() and obs.trace.enabled and rec.enabled


def test_unregistered_histogram_is_a_registry_child():
    """``Histogram`` (the standalone SLO probe the QoS tests feed) is a
    registry histogram child of its own registry: the registry's
    bucketing, cumulative ``get()``, always on, even with the default
    registry disabled."""
    h = obs.Histogram()
    assert h._metric.buckets == obs.TIME_BUCKETS
    obs.disable()
    try:
        for v in (0.0002, 0.3, 100.0):
            h.observe(v)
    finally:
        obs.enable()
    cum, total, count = h.get()
    assert count == 3 and cum[-1] == 3 and total == pytest.approx(100.3002)
    with pytest.raises(ValueError, match="sorted"):
        obs.Histogram(buckets=(1.0, 0.5))


def test_span_enters_record_function_only_while_capturing():
    """A span shows up by name in a ``torch.profiler`` capture around the
    operators it ran; outside a capture no ``record_function`` is
    entered (the annotation hook returns None)."""
    from bigdl_tpu_torch.observability import tracing

    assert tracing._profiler_annotation("x") is None
    tr = obs.Tracer()
    with torch.profiler.profile() as prof:
        with tr.span("obs/probe"):
            torch.ones(4).add_(1)
    keys = {e.key for e in prof.key_averages()}
    assert "obs/probe" in keys and "aten::add_" in keys
    assert tracing._profiler_annotation("x") is None


def test_tensorboard_bridge_into_the_ports_train_summary(reg, tmp_path):
    """The bridge over the port's ``visualization`` writer: the registry's
    series land as event-file scalars that ``read_scalar`` gives back."""
    from bigdl_tpu_torch.visualization import TrainSummary

    reg.counter("tb_total", "c").inc(3)
    reg.histogram("tb_h", "h", buckets=(1.0,)).observe(0.5)
    summ = TrainSummary(str(tmp_path), "obs")
    try:
        obs.TensorBoardBridge(summ, registry=reg).publish(step=4)
        summ.flush()
        # (step, wall time, value) triples
        assert [(r[0], r[2]) for r in summ.read_scalar("tb_total")] == \
            [(4, 3.0)]
        assert [(r[0], r[2]) for r in summ.read_scalar("tb_h_count")] == \
            [(4, 1.0)]
    finally:
        summ.close()
