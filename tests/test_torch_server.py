"""The port's server (``wavecap_tpu_torch/server``) against the JAX
package's, on the CPU (``AppServer(cfg, device="cpu")``).

Parity, both servers in one process on ephemeral ports with the fake
driver:

- the route tables: the same (method, pattern) set, HTTP and WebSocket;
- ``docs/api-spec.md``'s routes (``tests/test_api_conformance.py``'s
  parser): each registered on the port exactly as on the reference;
- one REST script (``tests/test_route_smoke.py``'s live ids and walk over
  every GET route, then ``tests/test_server.py``'s CRUD, error and
  trunking calls) through both: the same status and the same JSON key
  sets at every step;
- one capture's WebSocket audio and spectrum through both servers, the
  blocks (a seeded fake scene) dispatched inline by each engine's
  ``_dispatch_blocks``: the PCM >= 50 dB (``snr_db``) against the
  reference's from block 2 on, each spectrum frame within 0.2 dB (the
  frames are rounded to 0.1 dB) and the first block's PCM reported.

The reference's own server cases run on the port's server in
``tests/test_torch_server_cases.py``.  Every wait is on a count.
"""

from __future__ import annotations

import json
import re
import time

import httpx
import numpy as np
import pytest
import torch
from websockets.sync.client import connect as ws_connect

import tests.test_server as ref_server
from tests.conftest import snr_db
from tests.test_api_conformance import _fill, _spec_paths
from wavecap_tpu.server.app import AppServer as RefAppServer
from wavecap_tpu.utils.config import config_from_dict as ref_config_from_dict
from wavecap_tpu_torch.devices import DeviceConfig, FakeDriver, FakeStation
from wavecap_tpu_torch.server.app import AppServer
from wavecap_tpu_torch.utils.config import config_from_dict

torch.set_num_threads(1)

# the route smoke's server; the transport fixed at i16 (the adaptive
# controller would change it by the CPU's load, not by the blocks)
CFG = {"server": {"host": "127.0.0.1", "port": 0, "rate_limit_per_min": 1_000_000},
       "device": {"driver": "fake"}, "stream": {"adaptive_transport": False}}


def port_harness(cfg_dict: dict) -> ref_server.ServerHarness:
    """The reference tests' ``ServerHarness`` around the port's server."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_server, "AppServer", lambda cfg: AppServer(cfg, device="cpu"))
        return ref_server.ServerHarness(config_from_dict(cfg_dict)).start()


def ref_harness(cfg_dict: dict) -> ref_server.ServerHarness:
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_server, "AppServer", RefAppServer)
        return ref_server.ServerHarness(ref_config_from_dict(cfg_dict)).start()


@pytest.fixture(scope="module")
def pair():
    ref, port = ref_harness(CFG), port_harness(CFG)
    yield ref, port
    port.stop()
    ref.stop()


# --- the route tables --------------------------------------------------------------------


def routes(router) -> tuple[set, set]:
    return ({(m, rx.pattern) for m, rx, _ in router.routes}, {rx.pattern for rx, _ in router.ws_routes})


SPEC = _spec_paths()


@pytest.fixture(scope="module")
def routers():
    cfg = {"server": {"host": "127.0.0.1", "port": 0}, "device": {"driver": "fake"}}
    ref, port = RefAppServer(ref_config_from_dict(cfg)), AppServer(config_from_dict(cfg), device="cpu")
    yield ref.router, port.router
    port.state.shutdown()
    ref.state.shutdown()


def test_route_tables_match(routers):
    (rh, rw), (ph, pw) = (routes(r) for r in routers)
    assert ph == rh and pw == rw
    assert (len(ph), len(pw)) == (len(routers[0].routes), len(routers[0].ws_routes)) == (114, 11)


def found(router, method: str, path: str) -> str:
    """What the router does with a spec route: the handler's name, or
    ``405`` / ``404``."""
    concrete = "/api/v1" + _fill(path)
    if method == "WS":
        fn, _ = router.find_ws(concrete)
        return "404" if fn is None else fn.__name__
    try:
        fn, _ = router.find(method, concrete)
    except Exception as e:
        return str(getattr(e, "status", "405"))
    return "404" if fn is None else fn.__name__


@pytest.mark.parametrize("method,path", SPEC, ids=[f"{m} {p}" for m, p in SPEC])
def test_spec_route_is_registered_as_on_the_reference(routers, method, path):
    ref, port = routers
    assert found(port, method, path) == found(ref, method, path) != "404"


# --- one REST script through both servers --------------------------------------------------


def keys(d: dict) -> set:
    """A JSON object's keys; a capture's status (``blocksProcessed``)
    without ``device``, the torch device the port's engine adds to it."""
    return set(d) - {"device"} if "blocksProcessed" in d else set(d)


def shape(r: httpx.Response):
    """Status and JSON key sets (a list: the union of its elements'
    keys); other bodies by content type, unread (a stream may not end)."""
    kind = r.headers.get("content-type", "").split(";")[0]
    if kind != "application/json":
        return r.status_code, kind
    body = json.loads(r.read())
    if isinstance(body, dict):
        return r.status_code, sorted(keys(body))
    if isinstance(body, list):
        return r.status_code, "list", sorted({k for x in body if isinstance(x, dict) for k in keys(x)})
    return r.status_code, type(body).__name__


def smoke_ids(c: httpx.Client, scan: bool = False) -> dict:
    """``tests/test_route_smoke.py``'s live ids: a capture, a channel, a
    trunking system and a scanner (started with ``scan``)."""
    cap = c.post("/captures", json={"centerHz": 155e6, "sampleRate": 800_000}).json()
    ch = c.post(f"/captures/{cap['id']}/channels", json={"mode": "nbfm", "frequencyHz": 155.05e6}).json()
    c.post("/trunking/systems", json={"id": "smoke1", "control_channels": [851.2e6], "sample_rate": 2_400_000})
    scn = c.post("/scanners", json={"captureId": cap["id"], "channelId": ch["id"],
                                   "entries": [{"frequencyHz": 155.05e6}], "autoStart": scan})
    assert scn.status_code == 201, (cap, ch, scn.text)
    return {"cid": cap["id"], "chid": ch["id"], "sid": "smoke1", "rid": "airband", "did": "fake0",
            "scanner": scn.json()["id"]}


def get_walk(router, ids: dict) -> list[str]:
    """Every GET route with its ids filled as the route smoke fills them
    (routes that stream forever, and ``/recipes``, whose YAML differs by
    nothing but the file read, stay in: they answer or 404 alike)."""
    urls = []
    for method, rx, _ in router.routes:
        if method != "GET":
            continue
        pat = rx.pattern.strip("^$")

        def fill(m, pat=pat):
            name = m.group(1)
            if name == "sid":
                return ids["sid"] if "/trunking/" in pat else ids["scanner"]
            return ids.get(name, "dummy")

        url = re.sub(r"\(\?P<(\w+)>[^)]*\)", fill, pat).replace("\\", "")
        if "(" not in url:
            urls.append(url)
    return urls


# (name, method, path, json body): tests/test_server.py's CRUD, errors,
# metrics and trunking calls; {cid} / {chid} are this script's capture
SCRIPT = [
    ("create capture", "POST", "/captures", {"centerHz": 155e6, "sampleRate": 800_000}),
    ("create channel", "POST", "/captures/{cid}/channels", {"mode": "nbfm", "frequencyHz": 155.1e6, "name": "t"}),
    ("get capture", "GET", "/captures/{cid}", None),
    ("list channels", "GET", "/captures/{cid}/channels", None),
    ("patch channel", "PATCH", "/channels/{chid}", {"name": "renamed", "squelchDb": -40}),
    ("channel unknown format", "GET", "/stream/channels/{chid}.mp3", None),
    ("spectrum of a stopped capture", "GET", "/captures/{cid}/spectrum", None),
    ("delete channel", "DELETE", "/channels/{chid}", None),
    ("stop capture", "POST", "/captures/{cid}/stop", None),
    ("delete capture", "DELETE", "/captures/{cid}", None),
    ("unknown capture", "GET", "/captures/nope", None),
    ("delete unknown channel", "DELETE", "/channels/nope", None),
    ("bad json", "POST", "/captures", b"{bad json"),
    ("default capture", "POST", "/captures", {}),
    ("channel without frequency", "POST", "/captures/{cid}/channels", {"mode": "nbfm"}),
    ("channel out of range", "POST", "/captures/{cid}/channels", {"mode": "nbfm", "frequencyHz": 999e9}),
    ("delete default capture", "DELETE", "/captures/{cid}", None),
    ("metrics", "GET", "/system/metrics", None),
    ("logs", "GET", "/logs", None),
    ("errors", "GET", "/errors", None),
    ("perf", "GET", "/debug/perf", None),
    ("create system", "POST", "/trunking/systems",
     {"id": "tsys", "control_channels": [851.2e6], "sample_rate": 960_000,
      "talkgroups": [{"tgid": 100, "name": "Dispatch"}]}),
    ("talkgroups", "GET", "/trunking/systems/tsys/talkgroups", None),
    ("calls", "GET", "/trunking/systems/tsys/calls", None),
    ("delete system", "DELETE", "/trunking/systems/tsys", None),
    ("health", "GET", "/health", None),
    ("devices", "GET", "/devices", None),
]


def run_script(c: httpx.Client) -> dict:
    out, ids = {}, {}
    for name, method, path, body in SCRIPT:
        path = path.format(**ids)
        if isinstance(body, bytes):
            r = c.request(method, path, content=body)
        else:
            r = c.request(method, path, json=body)
        if name in ("create capture", "default capture"):
            ids["cid"] = r.json()["id"]
        if name == "create channel":
            ids["chid"] = r.json()["id"]
        out[name] = shape(r)
    return out


@pytest.fixture(scope="module")
def script_results(pair):
    res = []
    for h in pair:
        with httpx.Client(base_url=h.base, timeout=60) as c:
            res.append(run_script(c))
    return res


@pytest.mark.parametrize("step", [s[0] for s in SCRIPT])
def test_rest_script_step_matches_reference(script_results, step):
    ref, port = script_results
    assert port[step] == ref[step]


def test_every_get_route_answers_as_on_the_reference(pair):
    answers = []
    for h in pair:
        with httpx.Client(base_url=h.base, timeout=60) as c, \
                httpx.Client(base_url=f"http://127.0.0.1:{h.server.port}", timeout=60) as root:
            ids = smoke_ids(c)
            walk = {}
            for u in get_walk(pair[0].server.router, ids):
                with root.stream("GET", u) as r:
                    walk[u] = shape(r)
            answers.append(walk)
            c.delete(f"/scanners/{ids['scanner']}")
            c.delete(f"/captures/{ids['cid']}")
            c.delete("/trunking/systems/smoke1")
    ref, port = answers
    assert len(ref) >= 45
    assert {u: port.get(u) for u in ref if port.get(u) != ref[u]} == {}


# --- one capture's WebSocket audio and spectrum through both servers -----------------------

WS_CENTER, WS_RATE = 155e6, 800_000
WS_BLOCKS = 4


def ws_scene(block: int) -> list[np.ndarray]:
    """An NBFM station (1 kHz tone) 100 kHz up and an AM one 150 kHz down,
    plus the fake driver's noise (seed 42)."""
    stations = [FakeStation(offset_hz=100_000.0, kind="nbfm", tone_hz=1000.0, amplitude=0.1),
                FakeStation(offset_hz=-150_000.0, kind="am", tone_hz=700.0, amplitude=0.1)]
    dev = FakeDriver(1, stations).open("fake0")
    dev.configure(DeviceConfig(center_hz=WS_CENTER, sample_rate=WS_RATE))
    stream = dev.start_stream()
    return [stream.read(block)[0] for _ in range(WS_BLOCKS)]


def until(pred, what: str, limit: int = 2000) -> None:
    """Wait on a count: poll ``pred`` (the server's subscriber count) in
    steps of 5 ms, up to 10 s."""
    for _ in range(limit):
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"never: {what}")


def ws_run(h, blocks=None):
    """Create the capture and an NBFM channel on the station, subscribe
    the channel's audio and the capture's spectrum, dispatch the blocks
    inline; each block's PCM (int16) and spectrum frame."""
    with httpx.Client(base_url=h.base, timeout=60) as c:
        cid = c.post("/captures", json={"centerHz": WS_CENTER, "sampleRate": WS_RATE}).json()["id"]
        chid = c.post(f"/captures/{cid}/channels", json={"mode": "nbfm", "frequencyHz": WS_CENTER + 100e3}).json()["id"]
        cap = h.server.state.get_capture(cid)
        ch = cap.channels[chid]
        blocks = ws_scene(cap.block_size) if blocks is None else blocks
        pcm, spec = [], []
        with ws_connect(f"{h.ws_base}/stream/channels/{chid}", open_timeout=30) as wa, \
                ws_connect(f"{h.ws_base}/stream/captures/{cid}/spectrum", open_timeout=30) as wsp:
            until(lambda: ch.audio.count == 1 and cap.spectrum_subs.count == 1, "subscribed")
            for block in blocks:
                cap._dispatch_blocks([block])
                pcm.append(np.frombuffer(wa.recv(timeout=120), np.int16).astype(np.float32) / 32768.0)
                spec.append(json.loads(wsp.recv(timeout=120)))
        c.delete(f"/captures/{cid}")
    return blocks, pcm, spec


def test_ws_audio_and_spectrum_match_reference(pair):
    ref_h, port_h = pair
    blocks, rpcm, rspec = ws_run(ref_h)
    _, ppcm, pspec = ws_run(port_h, blocks)
    first = snr_db(rpcm[0], ppcm[0])
    for k in range(1, WS_BLOCKS):
        assert rpcm[k].shape == ppcm[k].shape and len(rpcm[k]) > 0
        assert snr_db(rpcm[k], ppcm[k]) >= 50.0, (k, snr_db(rpcm[k], ppcm[k]), first)
    for r, p in zip(rspec, pspec):
        assert {k: v for k, v in r.items() if k != "db"} == {k: v for k, v in p.items() if k != "db"}
        assert len(r["db"]) == len(p["db"]) == 2048
        assert np.max(np.abs(np.array(r["db"]) - np.array(p["db"]))) <= 0.2
    # the frames peak at the stations: 100 kHz up, 150 kHz down, each
    # >= 20 dB above the median bin
    db = np.array(pspec[-1]["db"])
    for off in (100e3, -150e3):
        k = 1024 + round(off / WS_RATE * 2048)
        assert db[k - 2:k + 3].max() >= np.median(db) + 20.0, off
