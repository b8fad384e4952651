"""MCP server: JSON-RPC 2.0 tool surface for AI assistants.

Behavioral port of reference ``mcp_server.py:34-850``: a tool registry
exposed over HTTP POST (JSON-RPC) plus SSE event stream, with optional
API-key auth.  Mounted under ``/mcp`` on the main server.

The port's copy of ``wavecap_tpu/server/mcp.py``, with the same public names.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Any, Callable

from .httpd import HttpError, Request, Response, Router

logger = logging.getLogger(__name__)

PROTOCOL_VERSION = "2024-11-05"


class McpToolRegistry:
    def __init__(self, state):
        self.state = state
        self.tools: dict[str, dict] = {}
        self._handlers: dict[str, Callable] = {}
        self._register_builtin()

    def tool(self, name: str, description: str, input_schema: dict | None = None):
        def deco(fn):
            self.tools[name] = {
                "name": name,
                "description": description,
                "inputSchema": input_schema
                or {"type": "object", "properties": {}, "required": []},
            }
            self._handlers[name] = fn
            return fn

        return deco

    async def call(self, name: str, arguments: dict) -> Any:
        fn = self._handlers.get(name)
        if fn is None:
            raise HttpError(404, f"unknown tool {name}")
        result = fn(self.state, arguments or {})
        if asyncio.iscoroutine(result):
            result = await result
        return result

    def _register_builtin(self) -> None:
        reg = self

        @reg.tool("list_devices", "List available SDR devices")
        def list_devices(state, args):
            return [
                {"id": d.id, "driver": d.driver, "label": d.label}
                for d in state.captures.list_devices()
            ]

        @reg.tool("list_captures", "List captures with status and channels")
        def list_captures(state, args):
            return [c.status() for c in state.captures.captures.values()]

        @reg.tool(
            "create_capture",
            "Create a capture (centerHz, sampleRate) and optionally start it",
            {
                "type": "object",
                "properties": {
                    "centerHz": {"type": "number"},
                    "sampleRate": {"type": "integer"},
                    "start": {"type": "boolean"},
                },
                "required": ["centerHz"],
            },
        )
        def create_capture(state, args):
            from wavecap_tpu_torch.capture import CaptureConfig

            cap = state.captures.create_capture(
                config=CaptureConfig(
                    center_hz=float(args["centerHz"]),
                    sample_rate=int(args.get("sampleRate", 2_400_000)),
                )
            )
            if args.get("start"):
                cap.start()
            return cap.status()

        @reg.tool(
            "create_channel",
            "Add a demod channel to a capture (captureId, mode, frequencyHz)",
            {
                "type": "object",
                "properties": {
                    "captureId": {"type": "string"},
                    "mode": {"type": "string"},
                    "frequencyHz": {"type": "number"},
                },
                "required": ["captureId", "frequencyHz"],
            },
        )
        def create_channel(state, args):
            from wavecap_tpu_torch.capture import ChannelSpec

            cap = state.get_capture(args["captureId"])
            ch = cap.create_channel(
                ChannelSpec(
                    id=state.new_channel_id(),
                    mode=args.get("mode", "nbfm"),
                    frequency_hz=float(args["frequencyHz"]),
                )
            )
            return {"id": ch.id, "mode": ch.spec.mode}

        @reg.tool(
            "tune_channel",
            "Retune an existing channel (channelId, frequencyHz)",
            {
                "type": "object",
                "properties": {
                    "channelId": {"type": "string"},
                    "frequencyHz": {"type": "number"},
                },
                "required": ["channelId", "frequencyHz"],
            },
        )
        def tune_channel(state, args):
            cap, ch = state.find_channel(args["channelId"])
            cap.update_channel(ch.id, frequency_hz=float(args["frequencyHz"]))
            return {"id": ch.id, "frequencyHz": ch.spec.frequency_hz}

        @reg.tool("list_trunking_systems", "List P25 trunking systems and status")
        def list_trunking(state, args):
            return state.trunking.status()

        @reg.tool("system_metrics", "Host and capture performance metrics")
        def metrics(state, args):
            from wavecap_tpu_torch.utils.observability import system_metrics

            return system_metrics()

        _CAP = {
            "type": "object",
            "properties": {"captureId": {"type": "string"}},
            "required": ["captureId"],
        }
        _CHAN = {
            "type": "object",
            "properties": {"channelId": {"type": "string"}},
            "required": ["channelId"],
        }
        _SYS = {
            "type": "object",
            "properties": {"systemId": {"type": "string"}},
            "required": ["systemId"],
        }

        @reg.tool("refresh_devices", "Re-enumerate SDR devices")
        def refresh_devices(state, args):
            return [
                {"id": d.id, "driver": d.driver, "label": d.label}
                for d in state.captures.list_devices()
            ]

        @reg.tool("get_device_health", "Driver/device health summary")
        def get_device_health(state, args):
            from wavecap_tpu_torch.utils.observability import ERROR_TRACKER

            return {
                "devices": len(state.captures.list_devices()),
                "captures": {
                    c.id: {"state": c.state, "restarts": c.restart_count}
                    for c in state.captures.captures.values()
                },
                "errorRates": ERROR_TRACKER.rates(),
            }

        @reg.tool("get_capture", "One capture's full status", _CAP)
        def get_capture(state, args):
            return state.get_capture(args["captureId"]).status()

        @reg.tool("start_capture", "Start a capture", _CAP)
        def start_capture(state, args):
            cap = state.get_capture(args["captureId"])
            cap.start()
            return cap.status()

        @reg.tool("stop_capture", "Stop a capture", _CAP)
        def stop_capture(state, args):
            cap = state.get_capture(args["captureId"])
            cap.stop()
            return cap.status()

        @reg.tool(
            "update_capture",
            "Retune a capture (captureId; centerHz/gainDb/ppm/bandwidthHz/"
            "antenna/agc apply live)",
            {
                "type": "object",
                "properties": {
                    "captureId": {"type": "string"},
                    "centerHz": {"type": "number"},
                    "gainDb": {"type": "number"},
                    "ppm": {"type": "number"},
                    "bandwidthHz": {"type": "number"},
                    "antenna": {"type": "string"},
                    "agc": {"type": "boolean"},
                },
                "required": ["captureId"],
            },
        )
        def update_capture(state, args):
            cap = state.get_capture(args["captureId"])
            kw = {}
            if "centerHz" in args:
                kw["center_hz"] = float(args["centerHz"])
            if "gainDb" in args:
                kw["gain_db"] = float(args["gainDb"])
            if "ppm" in args:
                kw["ppm"] = float(args["ppm"])
            if "bandwidthHz" in args:
                kw["bandwidth_hz"] = float(args["bandwidthHz"])
            if "antenna" in args:
                kw["antenna"] = str(args["antenna"])
            if "agc" in args:
                kw["agc"] = bool(args["agc"])
            cap.update_config(**kw)
            return cap.status()

        @reg.tool("list_channels", "All channels across captures")
        def list_channels(state, args):
            out = []
            for cap in state.captures.captures.values():
                for ch in cap.channels.values():
                    out.append(
                        {
                            "id": ch.id,
                            "captureId": cap.id,
                            "mode": ch.spec.mode,
                            "frequencyHz": ch.spec.frequency_hz,
                            "rssiDb": round(ch.rssi_db, 1),
                        }
                    )
            return out

        @reg.tool(
            "update_channel",
            "Update a channel (frequencyHz, squelchDb, mode, dsp overrides)",
            {
                "type": "object",
                "properties": {
                    "channelId": {"type": "string"},
                    "frequencyHz": {"type": "number"},
                    "squelchDb": {"type": ["number", "null"]},
                    "mode": {"type": "string"},
                    "dsp": {
                        "type": "object",
                        "description": "snake_case demod config overrides "
                        "(null value removes an override)",
                    },
                },
                "required": ["channelId"],
            },
        )
        def update_channel(state, args):
            cap, ch = state.find_channel(args["channelId"])
            kw = {}
            if "frequencyHz" in args:
                kw["frequency_hz"] = float(args["frequencyHz"])
            if "squelchDb" in args:
                v = args["squelchDb"]
                kw["squelch_db"] = None if v is None else float(v)
            if "mode" in args:
                kw["mode"] = str(args["mode"])
            if "dsp" in args and isinstance(args["dsp"], dict):
                kw["dsp"] = args["dsp"]
            cap.update_channel(ch.id, **kw)
            return {
                "id": ch.id,
                "frequencyHz": ch.spec.frequency_hz,
                "mode": ch.spec.mode,
                "squelchDb": ch.spec.squelch_db,
                "dsp": {k: list(v) if isinstance(v, tuple) else v
                        for k, v in ch.spec.dsp.items()},
            }

        @reg.tool("delete_channel", "Remove a channel", _CHAN)
        def delete_channel(state, args):
            cap, ch = state.find_channel(args["channelId"])
            cap.remove_channel(ch.id)
            return {"ok": True}

        @reg.tool("get_channel_metrics", "RSSI/state for one channel", _CHAN)
        def get_channel_metrics(state, args):
            cap, ch = state.find_channel(args["channelId"])
            return {
                "id": ch.id,
                "rssiDb": round(ch.rssi_db, 1),
                "state": ch.state,
                "rssiHistory": [
                    {"time": round(t, 1), "rssiDb": round(v, 1)}
                    for (t, v) in ch.rssi_history[-60:]
                ],
            }

        @reg.tool("start_trunking", "Start a trunking system", _SYS)
        def start_trunking(state, args):
            sysm = state.trunking.get(args["systemId"])
            sysm.start()
            return sysm.status()

        @reg.tool("stop_trunking", "Stop a trunking system", _SYS)
        def stop_trunking(state, args):
            sysm = state.trunking.get(args["systemId"])
            sysm.stop()
            return sysm.status()

        @reg.tool(
            "get_active_calls",
            "Active calls (one system via systemId, or all systems)",
        )
        def get_active_calls(state, args):
            sid = args.get("systemId")
            if sid:
                return state.trunking.get(sid).status()["activeCalls"]
            return [
                {"systemId": s.config.id, **c}
                for s in state.trunking.systems.values()
                for c in s.status()["activeCalls"]
            ]

        @reg.tool("get_talkgroups", "Configured talkgroups for a system", _SYS)
        def get_talkgroups(state, args):
            sysm = state.trunking.get(args["systemId"])
            return [
                {
                    "tgid": tg.tgid,
                    "name": tg.name,
                    "priority": tg.priority,
                    "record": tg.record,
                    "monitor": tg.monitor,
                }
                for tg in sysm.config.talkgroups.values()
            ]

        @reg.tool("get_recipes", "Available channel/trunking recipes")
        def get_recipes(state, args):
            from .app import load_recipes

            return list(load_recipes().values())

        @reg.tool(
            "identify_frequency",
            "Name/band/mode hint for a frequency (hz)",
            {
                "type": "object",
                "properties": {"hz": {"type": "number"}},
                "required": ["hz"],
            },
        )
        def identify_frequency(state, args):
            from wavecap_tpu_torch.utils import namers

            hz = float(args["hz"])
            band = namers.band_for(hz)
            return {
                "frequencyHz": hz,
                "name": namers.frequency_name(hz),
                "band": band.name if band else None,
                "modeHint": namers.mode_hint(hz),
            }

        @reg.tool("get_system_health", "Uptime, error rates, capture health")
        def get_system_health(state, args):
            from wavecap_tpu_torch.utils.observability import ERROR_TRACKER

            return {
                "uptimeS": round(__import__("time").time() - state.started_at, 1),
                "errorRates": ERROR_TRACKER.rates(),
                "captures": {
                    c.id: c.state for c in state.captures.captures.values()
                },
            }


def mount_mcp(router: Router, state, api_key: str | None = None) -> McpToolRegistry:
    registry = McpToolRegistry(state)

    def _check_auth(req: Request) -> None:
        if api_key and req.headers.get("x-api-key") != api_key:
            raise HttpError(401)

    @router.post("/mcp")
    async def mcp_rpc(req: Request) -> Response:
        _check_auth(req)
        msg = req.json()
        rid = msg.get("id")
        method = msg.get("method", "")
        try:
            if method == "initialize":
                result = {
                    "protocolVersion": PROTOCOL_VERSION,
                    "serverInfo": {"name": "wavecap-tpu", "version": "0.1.0"},
                    "capabilities": {"tools": {}},
                }
            elif method == "tools/list":
                result = {"tools": list(registry.tools.values())}
            elif method == "tools/call":
                params = msg.get("params") or {}
                out = await registry.call(
                    params.get("name", ""), params.get("arguments") or {}
                )
                result = {
                    "content": [{"type": "text", "text": json.dumps(out)}],
                    "isError": False,
                }
            elif method in ("notifications/initialized", "ping"):
                result = {}
            else:
                return Response.json(
                    {
                        "jsonrpc": "2.0",
                        "id": rid,
                        "error": {"code": -32601, "message": f"unknown method {method}"},
                    }
                )
        except HttpError as e:
            return Response.json(
                {
                    "jsonrpc": "2.0",
                    "id": rid,
                    "error": {"code": -32000, "message": e.message},
                }
            )
        except Exception as e:
            logger.exception("mcp tool error")
            return Response.json(
                {
                    "jsonrpc": "2.0",
                    "id": rid,
                    "error": {"code": -32000, "message": str(e)},
                }
            )
        return Response.json({"jsonrpc": "2.0", "id": rid, "result": result})

    return registry
