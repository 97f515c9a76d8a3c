"""The port's fleet incident merge, case for case with
tests/test_incidents.py::TestFleetIncidents (marked slow in the JAX
file; the port's runs here on the JAX file's small model).

Two in-process replicas behind the port's front door, one with a chaos
injector: a forced burn on r0 mints an incident whose bundles come back
over ``GET /debug/fleet/incidents`` stamped ``replica=r0``, with
exemplar trace ids that resolve in the merged fleet timelines. The
replicas serve weights copied from the JAX test's model by
``load_jax_params``, and every answer equals the JAX engine's row for
the same request. A replica without ``incident_export`` leaves the
merged view empty, not failing."""

import json
import time
import urllib.request

import jax
import numpy as np
import pytest

from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch.serving import ChaosInjector, ContinuousBatchingEngine
from bigdl_tpu_torch.serving.fleet import (
    FleetFrontDoor, InProcessReplica, ReplicaSupervisor,
)
from bigdl_tpu_torch.utils.weights import load_jax_params

PROMPTS = [list(range(1, 6 + i)) for i in range(3)] + [[1, 2, 3, 4]]


@pytest.fixture()
def reg():
    r = obs.MetricRegistry()
    prev = obs.set_default_registry(r)
    try:
        yield r
    finally:
        obs.set_default_registry(prev)
        obs.enable()


@pytest.fixture()
def rec():
    r = obs.FlightRecorder(capacity=256)
    prev = obs.set_default_recorder(r)
    try:
        yield r
    finally:
        obs.set_default_recorder(prev)


@pytest.fixture(scope="module")
def models():
    """The JAX test's small model and the port's copy of its weights,
    with the JAX engine's rows for every prompt of the file."""
    from bigdl_tpu.models.transformer import TransformerLM as JaxLM
    from bigdl_tpu.serving import ContinuousBatchingEngine as JaxEngine
    from bigdl_tpu.utils import random as rnd
    from bigdl_tpu_torch.models.transformer import TransformerLM

    rnd.set_seed(0)
    jm = JaxLM(64, embed_dim=32, num_heads=4, num_layers=2, max_len=64)
    jm.evaluate()
    tm = TransformerLM(64, embed_dim=32, num_heads=4, num_layers=2,
                       max_len=64, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    tm.evaluate()
    with JaxEngine(jm, max_slots=1, max_len=64, prefill_chunk=8) as eng:
        hs = [eng.submit(np.asarray(p, np.int32), 3) for p in PROMPTS]
        rows = {tuple(p): np.asarray(h.result(timeout=120))[
            len(p):].tolist() for p, h in zip(PROMPTS, hs)}
    return tm, rows


class TestFleetIncidents:
    def test_fleet_incidents_merge_and_trace_links(self, reg, rec,
                                                   models):
        model, rows = models
        chaos = ChaosInjector()
        reps = [
            InProcessReplica("r0", ContinuousBatchingEngine(
                model, max_slots=1, max_len=64, prefill_chunk=8,
                chaos=chaos, service_name="fi-r0")),
            InProcessReplica("r1", ContinuousBatchingEngine(
                model, max_slots=1, max_len=64, prefill_chunk=8,
                service_name="fi-r1")),
        ]
        with ReplicaSupervisor(reps, chunk=8,
                               fleet_name="fi") as sup, \
                FleetFrontDoor(sup) as door:
            base = f"http://127.0.0.1:{door.port}"

            def post(prompt):
                body = json.dumps({
                    "prompt_ids": prompt, "max_new_tokens": 3,
                    "stream": False}).encode()
                req = urllib.request.Request(
                    f"{base}/v1/generate", data=body,
                    headers={"Content-Type": "application/json"})
                out = json.loads(urllib.request.urlopen(
                    req, timeout=60).read())
                assert out["tokens"] == rows[tuple(prompt)]
                return out

            for p in PROMPTS[:3]:
                post(p)
            chaos.force_burn(active=True, severe=True)
            post(PROMPTS[3])
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                if reps[0].engine.debug_incidents()["count"]:
                    break
                time.sleep(0.1)
            chaos.force_burn(active=False)

            fi = json.loads(urllib.request.urlopen(
                f"{base}/debug/fleet/incidents?n=5",
                timeout=10).read())
            assert fi["count"] >= 1
            assert fi["by_kind"].get("slo", 0) >= 1
            assert all(b["replica"] == "r0" for b in fi["incidents"])
            assert "r0" in fi["detectors"] and "r1" in fi["detectors"]
            assert fi["trace_ids"], "exemplars must carry trace ids"
            assert fi["replicas"]["r1"] == {"count": 0, "error": None}
            fr = json.loads(urllib.request.urlopen(
                f"{base}/debug/fleet/requests", timeout=10).read())
            tls = fr.get("timelines")
            known = (set(tls) if isinstance(tls, dict)
                     else {t.get("trace_id") for t in tls or []})
            assert set(fi["trace_ids"]) <= known, \
                "every incident trace id resolves in the fleet trace"
            # the dashboard marks the incident on the shared clock
            markers = sup.fleet_markers()
            assert any(m["kind"] == "incident" and "r0" in m["label"]
                       for m in markers)

    def test_supervisor_incident_exports_duck_typing(self, reg, rec):
        class Bare:
            id = "bare"

            def start(self):
                pass

            def stop(self):
                pass

            def healthz(self):
                return {"status": "ok"}

            def stats(self):
                return {}

            def drain(self):
                pass

            def resume(self):
                pass

        from bigdl_tpu.serving.fleet import ReplicaSupervisor as JSup

        outs = []
        for sup_cls in (ReplicaSupervisor, JSup):
            sup = sup_cls([Bare()], fleet_name="duck")
            # no incident_export on the replica: merged view is empty,
            # not an error
            fi = sup.fleet_incidents()
            assert fi["count"] == 0 and fi["incidents"] == []
            outs.append(fi)
        assert outs[0] == outs[1]
