"""The port's API v1 vocabulary against the JAX package's: the wire
goldens byte for byte from samples built of the port's types, codec round
trips, and the gateway's error envelopes and search payloads, which must
be the reference's bytes on the same requests."""
import json
import math
import os
import types

import pytest

import test_api_codec as ref_codec_tests
from repro.api import HubGateway as RefGateway
from repro.api import TrustAuthority as RefAuthority
from repro.api import codec as ref_codec
from repro.api import types as RT
from repro.core.datastore import RuntimeDataStore as RefStore
from repro.core.hub import Hub as RefHub
from repro.core.hub import JobRepo as RefRepo
from repro.workloads import spark_emul as RW
from repro_torch.api import HubGateway, TrustAuthority, codec
from repro_torch.api import types as PT
from repro_torch.core import Hub, JobRepo, RuntimeDataStore
from repro_torch.workloads import spark_emul as PW

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "goldens",
                           "api_v1.json")
SCALEOUTS = (2, 3, 4, 6, 8, 12, 16)
PRICES = {m.name: m.price for m in PW.MACHINES.values()}

# tests/test_api_codec.py's golden corpus, built by its own code from the
# port's message types
port_golden_samples = types.FunctionType(
    ref_codec_tests.golden_samples.__code__,
    {**{cls.__name__: cls for cls in PT.MESSAGE_TYPES}, "math": math})


def _goldens():
    with open(GOLDEN_PATH) as f:
        return json.load(f)


def test_message_types_mirror_the_reference():
    assert [c.__name__ for c in PT.MESSAGE_TYPES] == \
        [c.__name__ for c in RT.MESSAGE_TYPES]
    for p, r in zip(PT.MESSAGE_TYPES, RT.MESSAGE_TYPES):
        assert [(f.name, repr(f.default)) for f in
                p.__dataclass_fields__.values()] == \
            [(f.name, repr(f.default)) for f in
             r.__dataclass_fields__.values()]
    for name in dir(RT):
        if name.startswith("ERR_") or name == "API_VERSION":
            assert getattr(PT, name) == getattr(RT, name), name


def test_golden_sample_encodings():
    golden = _goldens()
    samples = port_golden_samples()
    assert set(golden) == set(samples)
    for name, obj in samples.items():
        assert type(obj).__module__.startswith("repro_torch."), name
        assert codec.encode(obj) == golden[name], \
            f"wire format drifted for {name}"
        back = codec.decode(golden[name])
        assert type(back).__module__.startswith("repro_torch.")
        assert codec.encode(back) == golden[name]


@pytest.mark.parametrize("name", sorted(_goldens()))
def test_decode_then_encode_equals_the_reference(name):
    text = _goldens()[name]
    assert codec.encode(codec.decode(text)) == \
        ref_codec.encode(ref_codec.decode(text))


@pytest.mark.parametrize("msg", [
    PT.ChooseRequest("k\tmeans?", (math.inf, -0.0, 1e-300), t_max=math.nan,
                     seed=3),
    PT.ContributeRequest("ページランク", ("m5.xlarge",), ((1.0, 2.0),),
                         (math.inf,), contributor_id="üser-42"),
    PT.Response.success(PT.PredictResult((1e300, -math.inf), "gbm", 0.0,
                                         math.nan)),
    PT.Response.failure(PT.ERR_TIMEOUT, '"quoted" detail'),
    PT.Response.success(PT.StatsResult(
        3, 0, 1, True, math.nan, 1.5, 2.5,
        (PT.LaneSnapshot("grep@m5.xlarge<-sort#seed=2", 4, 2, 2.0, 1.0,
                         math.nan, 3.0),))),
    PT.AuthedRequest("ab" * 16, PT.TrustStateRequest("did:user:0x9f"))])
def test_round_trip_and_reference_bytes(msg):
    text = codec.encode(msg)
    assert codec.encode(codec.decode(text)) == text
    json.loads(text)                           # strict JSON
    assert ref_codec.encode(ref_codec.decode(text)) == text


def test_unencodable_value_raises():
    with pytest.raises(TypeError):
        codec.encode(object())
    with pytest.raises(TypeError):
        codec.encode(types.SimpleNamespace(a=1))


# --------------------------------------------------- envelopes vs reference

def _hubs():
    """grep and sort published on both sides; nothing here fits."""
    ref, port = RefHub(), Hub()
    for job in ("grep", "sort"):
        ref.publish(RefRepo(job, f"spark {job}",
                            RW.generate_job_data(job).schema,
                            RefStore(RW.generate_job_data(job), seed=0)))
        d = PW.generate_job_data(job)
        port.publish(JobRepo(job, f"spark {job}", d.schema,
                             RuntimeDataStore(d, seed=0, device="cpu"),
                             predictor_kw={"device": "cpu"}))
    return ref, port


def _both(requests, **kw):
    """Each request (built from the reference's types) served by both
    gateways: (reference bytes, port bytes) pairs."""
    ref, port = _hubs()
    clock = [0.0]
    auth_kw = kw.pop("auth", None)
    gws = []
    for hub, Gateway, Authority in ((ref, RefGateway, RefAuthority),
                                    (port, HubGateway, TrustAuthority)):
        auth = None if auth_kw is None else Authority(
            clock=lambda: clock[0], **auth_kw)
        gws.append(Gateway(hub, PRICES, SCALEOUTS, auth=auth, **kw))
    out = []
    for req in requests:
        text = ref_codec.encode(req)
        out.append((ref_codec.encode(gws[0].handle(req)),
                    codec.encode(gws[1].handle(codec.decode(text)))))
    return out, gws


ROW = (4.0, 15.0, 0.02)


@pytest.mark.parametrize("req", [
    RT.PredictRequest("nope", "m5.xlarge", (ROW,)),
    RT.ChooseRequest("nope", (15.0, 0.02)),
    RT.PredictRequest("grep", "m5.xlarge", ((4.0, 15.0),)),
    RT.PredictRequest("grep", "warp-drive", (ROW,)),
    RT.ChooseRequest("grep", (15.0,)),
    RT.ChooseRequest("grep", (15.0, 0.02), zones=("az-1a",)),
    RT.ContributeRequest("grep", ("m5.xlarge",), (ROW,), (1.0, 2.0)),
    RT.ContributeRequest("grep", ("m5\txlarge",), (ROW,), (1.0,)),
    RT.ContributeRequest("grep", ("m5.xlarge",), (ROW,), (1.0,),
                         contributor_id="a\nb"),
    RT.ModelErrorsRequest("nope", "m5.xlarge", (ROW,), (1.0,)),
    RT.ModelErrorsRequest("grep", "m5.xlarge", (ROW,), (1.0, 2.0)),
    RT.SearchRequest("grep"), RT.SearchRequest(""),
    RT.SearchRequest("SPARK"), RT.SearchRequest("pagerank"),
    RT.TrustStateRequest("alice"),
    RT.CompactRequest("nope"), RT.CompactRequest("grep"),
    RT.CompactRequest("grep", max_rows_per_cell=0)],
    ids=lambda r: type(r).__name__)
def test_error_envelopes_and_search_payloads_are_the_reference_bytes(req):
    (want, got), = _both([req])[0]
    assert got == want


def test_trust_refusals_are_the_reference_bytes():
    """Unauthorized (no token, unknown token, banned) and quota refusals
    from an auth-enabled gateway, on a frozen clock."""
    pairs, gws = _both([], auth={"rate": 1.0, "burst": 2.0})
    ref_gw, port_gw = gws
    tokens = [gw.issue_token("alice") for gw in gws]
    gws[0].issue_token("mallory")
    gws[1].issue_token("mallory")
    search = RT.SearchRequest("grep")
    cases = [search, RT.AuthedRequest("deadbeef", search)]
    got = []
    for gw, tok, enc, mod in ((ref_gw, tokens[0], ref_codec, RT),
                              (port_gw, tokens[1], codec, PT)):
        out = []
        for req in cases:
            out.append(enc.encode(gw.handle(enc.decode(
                ref_codec.encode(req)))))
        wrapped = mod.AuthedRequest(tok, mod.SearchRequest("grep"))
        out += [enc.encode(gw.handle(wrapped)) for _ in range(3)]
        gw.ban_contributor("alice")
        out.append(enc.encode(gw.handle(wrapped)))
        out.append(enc.encode(gw.handle(mod.TrustStateRequest("alice"))))
        got.append(out)
    assert got[1] == got[0]
    codes = [json.loads(t)["error_code"] for t in got[1]]
    assert codes == ["unauthorized", "unauthorized", "", "",
                     "quota_exceeded", "unauthorized", "unauthorized"]
