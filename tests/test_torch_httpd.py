"""The port's HTTP/WS layer and frontend (``wavecap_tpu_torch/server``:
``httpd.py``, ``encoders.py``, ``mcp.py``, ``static/``) on the CPU.

- The stdlib copies (``httpd``, ``encoders``, ``mcp``, ``__init__``) are
  the reference's line for line but for their imports and the docstring
  line naming the reference; ``static/`` is the reference's byte for byte.
- ``tests/test_httpd_hardening.py``'s cases against the port's
  ``HttpServer``: each class a subclass of the reference's, its raw-socket
  harness built on the port's ``HttpServer`` / ``Router`` / ``Response``
  and its ``httpd`` (the module whose limits the cases patch) the port's.
- ``tests/test_frontend_assets.py``'s and ``tests/test_e2e_specs.py``'s
  cases pointed at the port's ``static/`` (``STATIC`` patched) and, where
  they read the router, at the port's.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest
import torch

import tests.test_e2e_specs as ref_e2e
import tests.test_frontend_assets as ref_assets
import tests.test_httpd_hardening as ref_hard
import wavecap_tpu.server
from wavecap_tpu_torch.server import httpd as port_httpd
from wavecap_tpu_torch.server.app import AppState, build_router
from wavecap_tpu_torch.utils.config import config_from_dict

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "wavecap_tpu" / "server", ROOT / "wavecap_tpu_torch" / "server"


# --- the copies ------------------------------------------------------------------------------


def split_docstring(src: str) -> tuple[str, list[str]]:
    """A module's docstring and the lines after it."""
    tree = ast.parse(src)
    return ast.get_docstring(tree, clean=False), src.splitlines()[tree.body[0].end_lineno:]


@pytest.mark.parametrize("name", ["httpd.py", "encoders.py", "mcp.py", "__init__.py"])
def test_stdlib_copies_match_the_reference(name):
    ref_doc, ref = split_docstring((REF / name).read_text().replace("wavecap_tpu.", "wavecap_tpu_torch."))
    port_doc, port = split_docstring((PORT / name).read_text())
    note = f"The port's copy of ``wavecap_tpu/server/{name}``, with the same public names."
    assert port_doc.startswith(ref_doc.rstrip()) and port_doc.rstrip().endswith(note)
    assert port == ref


def test_static_is_the_reference_byte_for_byte():
    ref = {p.relative_to(REF / "static"): p.read_bytes() for p in (REF / "static").rglob("*") if p.is_file()}
    port = {p.relative_to(PORT / "static"): p.read_bytes() for p in (PORT / "static").rglob("*") if p.is_file()}
    assert len(ref) >= 15 and port == ref


# --- the hardening cases on the port's HttpServer ------------------------------------------


@pytest.fixture(scope="module")
def harness():
    """The reference's raw harness and routes, built on the port's
    ``HttpServer``, ``Router`` and ``Response`` (kept so while the
    module's cases run: the routes' handlers read ``Response`` then)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("HttpServer", "Router", "Response"):
            mp.setattr(ref_hard, name, getattr(port_httpd, name))
        gen = ref_hard.harness.__wrapped__()
        yield next(gen)
        next(gen, None)


@pytest.fixture(autouse=True)
def _limits_are_the_ports(monkeypatch):
    """The cases patch ``httpd``'s limits (a module global, or imported
    from ``wavecap_tpu.server`` in a case's body): the port's module."""
    monkeypatch.setattr(ref_hard, "httpd", port_httpd)
    monkeypatch.setattr(wavecap_tpu.server, "httpd", port_httpd)


class TestProtocolEdges(ref_hard.TestProtocolEdges):
    pass


class TestWebSocketProtocolEdges(ref_hard.TestWebSocketProtocolEdges):
    pass


class TestSlowConsumer(ref_hard.TestSlowConsumer):
    pass


def test_the_cases_reach_the_ports_server(harness):
    assert type(harness.server) is port_httpd.HttpServer


# --- the frontend and the e2e specs on the port's static/ ------------------------------------


@pytest.fixture()
def port_static(monkeypatch):
    monkeypatch.setattr(ref_assets, "STATIC", PORT / "static")
    monkeypatch.setattr(ref_e2e, "STATIC", PORT / "static")


ASSET_CASES = ["test_import_graph_resolves", "test_named_imports_are_exported", "test_css_classes_used_are_defined",
               "test_css_served_name_matches"]


@pytest.mark.parametrize("case", ASSET_CASES)
def test_frontend_asset_case_on_the_port(port_static, case):
    getattr(ref_assets.TestFrontendAssets(), case)()
    assert all(PORT in f.parents for f in ref_assets.js_modules())


def port_js_modules():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_assets, "STATIC", PORT / "static")
        return ref_assets.js_modules()


@pytest.mark.parametrize("f", port_js_modules(), ids=lambda f: f.name)
def test_brackets_balance_on_the_port(f):
    ref_assets.TestFrontendAssets().test_brackets_balance(f)


@pytest.fixture(scope="module")
def router():
    state = AppState(config_from_dict({"device": {"driver": "fake"}}), device="cpu")
    yield build_router(state)
    state.shutdown()


def test_frontend_api_paths_exist_in_the_ports_router(port_static, router):
    """``test_api_paths_exist_in_router`` on the port: every literal
    ``/api`` path and WebSocket the port's frontend uses has a route."""
    methods = {"get": "GET", "post": "POST", "patch": "PATCH", "put": "PUT", "del": "DELETE"}
    misses, seen = [], 0
    for f in ref_assets.js_modules():
        src = f.read_text()
        for m in re.finditer(r'api\.(get|post|patch|put|del)\(\s*[`"](/[^`"?]+)', src):
            path = re.sub(r"\$\{[^}]+\}", "x", m.group(2))
            seen += 1
            if router.find(methods[m.group(1)], "/api/v1" + path)[0] is None:
                misses.append((f.name, m.group(1), path))
        for m in re.finditer(r'openWs\(\s*[`"](/[^`"?]+)', src):
            path = re.sub(r"\$\{[^}]+\}", "x", m.group(1))
            seen += 1
            if router.find_ws("/api/v1" + path)[0] is None:
                misses.append((f.name, "ws", path))
    assert seen >= 20 and not misses, misses


E2E_CASES = ["test_spec_files_exist", "test_text_selectors_exist_in_spa", "test_class_selectors_exist",
             "test_modal_field_labels_exist"]


@pytest.mark.parametrize("case", E2E_CASES)
def test_e2e_spec_case_on_the_port(port_static, case):
    getattr(ref_e2e.TestE2eSpecs(), case)()


def test_e2e_health_url_has_a_route_on_the_port(router):
    """``test_webserver_command_targets_real_entrypoint``'s route half on
    the port: the health URL the e2e suite waits on is served."""
    cfg = (ref_e2e.E2E / "playwright.config.ts").read_text()
    m = re.search(r'url:\s*"http://[^/]+(/[^"]+)"', cfg)
    assert m and router.find("GET", m.group(1))[0] is not None
