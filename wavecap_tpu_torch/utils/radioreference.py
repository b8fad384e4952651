"""RadioReference talkgroup import (reference ``radioreference.py:201``).

SOAP API client via httpx (gated — this build env has no egress, so the
primary path is the CSV importer in ``trunking/config.py``; the API
client parses the same ``getTrunkedSystemTalkgroups`` response shape).

The port's copy of ``wavecap_tpu/utils/radioreference.py``, with the same public names.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass

from wavecap_tpu_torch.trunking.config import TalkgroupConfig

logger = logging.getLogger(__name__)

_RR_ENDPOINT = "http://api.radioreference.com/soap2/?s=rpc&v=latest"

_ENVELOPE = """<?xml version="1.0" encoding="UTF-8"?>
<SOAP-ENV:Envelope xmlns:SOAP-ENV="http://schemas.xmlsoap.org/soap/envelope/">
<SOAP-ENV:Body>
<getTrunkedTalkgroups>
<sid>{sid}</sid>
<authInfo><username>{username}</username><password>{password}</password>
<appKey>{app_key}</appKey><version>latest</version></authInfo>
</getTrunkedTalkgroups>
</SOAP-ENV:Body></SOAP-ENV:Envelope>"""


@dataclass
class RadioReferenceClient:
    username: str
    password: str
    app_key: str
    timeout_s: float = 30.0

    def fetch_talkgroups(self, system_id: int) -> dict[int, TalkgroupConfig]:
        import httpx

        body = _ENVELOPE.format(
            sid=system_id,
            username=self.username,
            password=self.password,
            app_key=self.app_key,
        )
        resp = httpx.post(
            _RR_ENDPOINT,
            content=body,
            headers={"Content-Type": "text/xml"},
            timeout=self.timeout_s,
        )
        resp.raise_for_status()
        return parse_talkgroups_response(resp.text)


def parse_talkgroups_response(xml_text: str) -> dict[int, TalkgroupConfig]:
    """Parse the SOAP response's talkgroup structs (regex-tolerant)."""
    out: dict[int, TalkgroupConfig] = {}
    for item in re.finditer(r"<item[^>]*>(.*?)</item>", xml_text, re.S):
        block = item.group(1)

        def field(name: str) -> str:
            m = re.search(rf"<{name}[^>]*>(.*?)</{name}>", block, re.S)
            return (m.group(1) if m else "").strip()

        tgid_s = field("tgDec") or field("tgId")
        if not tgid_s:
            continue
        try:
            tgid = int(tgid_s)
        except ValueError:
            continue
        out[tgid] = TalkgroupConfig(
            tgid=tgid,
            name=field("tgAlpha") or field("tgDescr") or f"TG {tgid}",
            category=field("tgCat"),
        )
    return out
