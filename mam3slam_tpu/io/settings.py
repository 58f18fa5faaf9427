"""Per-agent YAML settings (reference ``src/Settings.cc`` / Settings.h).

Parses the reference's OpenCV-FileStorage YAML dialect (leading
``%YAML:1.0`` directive, dotted keys) with the same ``File.version`` gate
(`src/Agent.cc:22-29`), camera sections (Pinhole / KannalaBrandt8 /
Rectified), ORB parameters, and viewer/load-save sections.  The dialect is
read by ``parse_filestorage`` below, so no YAML library is needed.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

from mam3slam_tpu.geometry import cameras


class SettingsError(ValueError):
    pass


@dataclass
class Settings:
    camera_type: str
    fx: float
    fy: float
    cx: float
    cy: float
    dist: tuple              # (k1, k2, p1, p2) or KB8 (k1..k4)
    width: int
    height: int
    fps: float
    rgb: bool
    n_features: int
    scale_factor: float
    n_levels: int
    ini_th_fast: int
    min_th_fast: int
    new_width: Optional[int] = None
    new_height: Optional[int] = None
    atlas_load_file: str = ""
    atlas_save_file: str = ""
    raw: dict = field(default_factory=dict)

    @property
    def eff_width(self) -> int:
        """Working image width after the optional Camera.newWidth resize
        (reference Settings stereo/resize derivation + Agent.cc:135-140)."""
        return self.new_width or self.width

    @property
    def eff_height(self) -> int:
        return self.new_height or self.height

    def camera(self) -> cameras.Camera:
        """Camera at the WORKING resolution: focal lengths / principal
        point scale with the resize; normalized distortion coefficients do
        not (reference Settings.cc resize handling)."""
        sx = self.eff_width / self.width
        sy = self.eff_height / self.height
        fx, fy = self.fx * sx, self.fy * sy
        cx, cy = self.cx * sx, self.cy * sy
        if self.camera_type == "KannalaBrandt8":
            return cameras.make_kb8(fx, fy, cx, cy, *self.dist[:4])
        return cameras.make_pinhole(fx, fy, cx, cy, tuple(self.dist[:4]))


def _req(d: dict, key: str):
    if key not in d:
        raise SettingsError(f"required parameter missing: {key}")
    return d[key]


_NUMBER = re.compile(r"[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that is not inside a quoted string."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#":
            return line[:i]
    return line


def _scalar(text: str):
    """A FileStorage scalar: quoted string, int, float, or bare word."""
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    if _NUMBER.match(text):
        return float(text) if re.search(r"[.eE]", text) else int(text)
    return text


def parse_filestorage(text: str) -> dict:
    """Parse the OpenCV-FileStorage YAML dialect of the reference's
    settings files: the ``%YAML:1.0`` header, ``key: value`` lines with
    comments, quoted strings and numbers, and indented sub-blocks such as
    ``!!opencv-matrix`` (``rows``/``cols``/``dt``/``data: [...]``, a flow
    list that may span lines), which become nested dicts."""
    d: dict = {}
    block = None          # dict of the open indented sub-block
    pending = None        # (target dict, key, text) of an unclosed [ list
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if pending is not None:
            tgt, key, acc = pending
            acc += " " + line.strip()
            if "]" in acc:
                tgt[key] = [_scalar(v) for v in
                            acc[acc.index("[") + 1:acc.index("]")].split(",")
                            if v.strip()]
                pending = None
            else:
                pending = (tgt, key, acc)
            continue
        if not line.strip() or line.lstrip().startswith(("%", "---")):
            continue
        key, sep, val = line.strip().partition(":")
        if not sep:
            raise SettingsError(f"not a key: value line: {raw!r}")
        key, val = key.strip(), val.strip()
        indented = line[0] in " \t"
        if indented and block is None:
            raise SettingsError(f"unexpected indentation: {raw!r}")
        tgt = block if indented else d
        if not indented:
            block = None
        if val.startswith("!!") or val == "":
            tgt[key] = block = {}
        elif val.startswith("["):
            if "]" in val:
                tgt[key] = [_scalar(v) for v in val[1:val.index("]")]
                            .split(",") if v.strip()]
            else:
                pending = (tgt, key, val)
        else:
            tgt[key] = _scalar(val)
    if pending is not None:
        raise SettingsError(f"unterminated list for {pending[1]!r}")
    return d


def load_settings(path: str) -> Settings:
    with open(path) as f:
        d = parse_filestorage(f.read())

    version = d.get("File.version")
    if version != "1.0":
        # reference Agent ctor rejects settings without the version tag
        raise SettingsError(
            f"unsupported settings version {version!r} (need \"1.0\")")

    cam_type = str(_req(d, "Camera.type"))
    if cam_type in ("PinHole", "Pinhole"):
        dist = tuple(float(d.get(f"Camera1.{k}", 0.0))
                     for k in ("k1", "k2", "p1", "p2"))
    elif cam_type == "KannalaBrandt8":
        dist = tuple(float(_req(d, f"Camera1.{k}"))
                     for k in ("k1", "k2", "k3", "k4"))
    elif cam_type == "Rectified":
        dist = (0.0, 0.0, 0.0, 0.0)
    else:
        raise SettingsError(f"unknown Camera.type {cam_type!r}")

    return Settings(
        camera_type=cam_type,
        fx=float(_req(d, "Camera1.fx")),
        fy=float(_req(d, "Camera1.fy")),
        cx=float(_req(d, "Camera1.cx")),
        cy=float(_req(d, "Camera1.cy")),
        dist=dist,
        width=int(_req(d, "Camera.width")),
        height=int(_req(d, "Camera.height")),
        fps=float(d.get("Camera.fps", 30.0)),
        rgb=bool(d.get("Camera.RGB", 1)),
        n_features=int(d.get("ORBextractor.nFeatures", 1000)),
        scale_factor=float(d.get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(d.get("ORBextractor.nLevels", 8)),
        ini_th_fast=int(d.get("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(d.get("ORBextractor.minThFAST", 7)),
        new_width=(int(d["Camera.newWidth"])
                   if d.get("Camera.newWidth") else None),
        new_height=(int(d["Camera.newHeight"])
                    if d.get("Camera.newHeight") else None),
        atlas_load_file=d.get("System.LoadAtlasFromFile", ""),
        atlas_save_file=d.get("System.SaveAtlasToFile", ""),
        raw=d,
    )
