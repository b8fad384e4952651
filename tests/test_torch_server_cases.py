"""The reference's server cases on the port's server, on the CPU.

``tests/test_server.py``'s classes, ``tests/test_route_smoke.py``'s two
walks and ``tests/test_concurrent_api.py``, each class a subclass of the
reference's: its fixtures (``harness``, ``client``, ``ids``) build the
port's ``AppServer(cfg, device="cpu")`` in the reference's
``ServerHarness``, and inside the cases a ``ServerHarness(cfg)`` builds
the port's too (``AppServer`` in ``tests/test_server.py`` pointed at the
port's).  The cases talk to the server over HTTP and WebSocket only, so
each holds the port's server to the reference's own assertions.
"""

from __future__ import annotations

import httpx
import pytest
import torch

import tests.test_concurrent_api as ref_concurrent
import tests.test_route_smoke as ref_smoke
import tests.test_server as ref_server
from tests.test_torch_server import port_harness, smoke_ids
from wavecap_tpu_torch.server.app import AppServer

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _servers_built_by_the_port(monkeypatch):
    """Inside the reference's cases a ``ServerHarness(cfg)`` builds the
    port's server."""
    monkeypatch.setattr(ref_server, "AppServer", lambda cfg: AppServer(cfg, device="cpu"))


@pytest.fixture(scope="module")
def harness():
    h = port_harness({"server": {"host": "127.0.0.1", "port": 0, "rate_limit_per_min": 100000},
                      "device": {"driver": "fake"}})
    yield h
    h.stop()


@pytest.fixture(scope="module")
def client(harness):
    with httpx.Client(base_url=harness.base, timeout=30) as c:
        yield c


@pytest.fixture(scope="module")
def ids(harness):
    with httpx.Client(base_url=harness.base, timeout=60) as c:
        return smoke_ids(c, scan=True)


class TestRest(ref_server.TestRest):
    pass


class TestWebSockets(ref_server.TestWebSockets):
    pass


class TestMcp(ref_server.TestMcp):
    pass


class TestScannerAndAttachments(ref_server.TestScannerAndAttachments):
    pass


class TestMiscEndpoints(ref_server.TestMiscEndpoints):
    pass


class TestTrunkingWorkerMode(ref_server.TestTrunkingWorkerMode):
    pass


class TestDeviceHealthAndClassifier(ref_server.TestDeviceHealthAndClassifier):
    pass


class TestHttpChunkedAudio(ref_server.TestHttpChunkedAudio):
    pass


class TestRecipes(ref_server.TestRecipes):
    pass


class TestClientDisconnectRelease(ref_server.TestClientDisconnectRelease):
    pass


class TestTalkgroupEditing(ref_server.TestTalkgroupEditing):
    pass


class TestTrunkingApiLongTail(ref_server.TestTrunkingApiLongTail):
    pass


class TestReferencePathParity(ref_server.TestReferencePathParity):
    pass


class TestTalkgroupPostAndActiveCalls(ref_server.TestTalkgroupPostAndActiveCalls):
    pass


class TestRecordingsBrowser(ref_server.TestRecordingsBrowser):
    pass


class TestPerSystemEventStream(ref_server.TestPerSystemEventStream):
    pass


class TestMcpToolCoverage(ref_server.TestMcpToolCoverage):
    pass


class TestRound3ApiCrumbs(ref_server.TestRound3ApiCrumbs):
    pass


class TestPagerAttachmentDsp(ref_server.TestPagerAttachmentDsp):
    pass


class TestConcurrentOperations(ref_concurrent.TestConcurrentOperations):
    pass


def test_all_get_routes_respond_without_500(harness, ids):
    ref_smoke.test_all_get_routes_respond_without_500(harness, ids)


def test_all_ws_routes_handshake(harness, ids):
    ref_smoke.test_all_ws_routes_handshake(harness, ids)
