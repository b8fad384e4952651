"""Device and frequency naming (reference ``device_namer.py`` /
``frequency_namer.py``): auto-labels like "FM 90.3 - RTL" from band plans.

The port's copy of ``wavecap_tpu/utils/namers.py``, with the same public names.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Band:
    low_hz: float
    high_hz: float
    name: str
    mode_hint: str = ""


# Built-in defaults; config/frequency_bands.yaml (reference parity:
# reference config/frequency_bands.yaml -> frequency_namer.py:219)
# overrides/extends these at import — see load_band_plan().
BANDS = [
    Band(87.5e6, 108.0e6, "FM Broadcast", "wbfm"),
    Band(108.0e6, 118.0e6, "Air Nav", "am"),
    Band(118.0e6, 137.0e6, "Airband", "am"),
    Band(137.0e6, 138.0e6, "Weather Sat", ""),
    Band(144.0e6, 148.0e6, "2m Amateur", "nbfm"),
    Band(156.0e6, 162.025e6, "Marine VHF", "nbfm"),
    Band(162.4e6, 162.55e6, "NOAA Weather", "nbfm"),
    Band(148.0e6, 174.0e6, "VHF Public Safety", "nbfm"),
    Band(420.0e6, 450.0e6, "70cm Amateur", "nbfm"),
    Band(450.0e6, 470.0e6, "UHF Business", "nbfm"),
    Band(470.0e6, 512.0e6, "UHF-T Public Safety", "p25"),
    Band(764.0e6, 776.0e6, "700 MHz Public Safety", "p25"),
    Band(806.0e6, 824.0e6, "800 MHz Trunking (mobile)", "p25"),
    Band(851.0e6, 869.0e6, "800 MHz Trunking", "p25"),
    Band(902.0e6, 928.0e6, "33cm ISM", ""),
    Band(929.0e6, 932.0e6, "Paging", "pocsag"),
    Band(1090.0e6 - 1e6, 1090.0e6 + 1e6, "ADS-B", ""),
]


_loaded_bands: list[Band] | None = None


def load_band_plan(path: str | None = None) -> list[Band]:
    """Bands from ``config/frequency_bands.yaml`` (+ built-in defaults).

    File entries come first (first match wins), then any built-in band
    not covered by the file.  Missing/invalid file -> built-ins only.
    Reference parity: ``config/frequency_bands.yaml`` consumed by
    reference ``frequency_namer.py:219``."""
    global _loaded_bands
    if path is None and _loaded_bands is not None:
        return _loaded_bands
    from pathlib import Path

    cand = (
        Path(path)
        if path
        else Path(__file__).resolve().parents[2] / "config" / "frequency_bands.yaml"
    )
    bands: list[Band] = []
    try:
        import yaml

        doc = yaml.safe_load(cand.read_text()) or {}
        for e in doc.get("bands", []) or []:
            try:
                bands.append(
                    Band(
                        low_hz=float(e["low_mhz"]) * 1e6,
                        high_hz=float(e["high_mhz"]) * 1e6,
                        name=str(e["name"]),
                        mode_hint=str(e.get("mode_hint", "") or ""),
                    )
                )
            except (KeyError, TypeError, ValueError):
                continue
    except Exception:  # missing file / no yaml: built-ins only
        pass
    names = {b.name for b in bands}
    bands += [b for b in BANDS if b.name not in names]
    if path is None:
        _loaded_bands = bands
    return bands


def band_for(freq_hz: float) -> Band | None:
    for b in load_band_plan():
        if b.low_hz <= freq_hz < b.high_hz:
            return b
    return None


def frequency_name(freq_hz: float) -> str:
    mhz = freq_hz / 1e6
    band = band_for(freq_hz)
    if band is None:
        return f"{mhz:.4f} MHz".rstrip("0").rstrip(".")
    if band.name == "FM Broadcast":
        return f"FM {mhz:.1f}"
    if band.name == "Marine VHF":
        ch = marine_channel(freq_hz)
        return f"Marine {mhz:.3f}" + (f" (ch {ch})" if ch else "")
    return f"{band.name} {mhz:.4f}".rstrip("0").rstrip(".")


def marine_channel(freq_hz: float) -> int | None:
    """VHF marine simplex channel number for common frequencies."""
    table = {156.050e6: 1, 156.300e6: 6, 156.450e6: 9, 156.500e6: 10,
             156.550e6: 11, 156.600e6: 12, 156.650e6: 13, 156.700e6: 14,
             156.800e6: 16, 156.850e6: 17, 157.100e6: 22}
    for f, ch in table.items():
        if abs(freq_hz - f) < 1000:
            return ch
    return None


def mode_hint(freq_hz: float) -> str:
    band = band_for(freq_hz)
    return band.mode_hint if band else "nbfm"


def device_nickname(label: str, serial: str = "", index: int = 0) -> str:
    short = label
    for verbose, compact in [
        ("Generic RTL2832U OEM", "RTL"),
        ("RTLSDRBlog", "RTL V4"),
        ("SDRplay", "SDRplay"),
        ("Fake SDR", "Fake"),
        ("Native ingest ring", "Native"),
    ]:
        if verbose.lower() in label.lower():
            short = compact
            break
    suffix = serial[-4:] if serial else (str(index) if index else "")
    return f"{short} {suffix}".strip()


def capture_name(center_hz: float, device_label: str = "") -> str:
    base = frequency_name(center_hz)
    return f"{base} - {device_label}" if device_label else base
