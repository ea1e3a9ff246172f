"""Run-directory naming, compatible with the reference's output layout (the
port's own copy of audio_style_transfer_tpu/utils/paths.py).

Reproduces the parameter-encoded directory scheme of reference
utils.py:18-76 (``gt_s_path`` with the abbreviation table at utils.py:14-15
and the date folder of ``crt_t_fol``) so existing tooling/scripts that
expect those paths keep working.
"""

from __future__ import annotations

import os
import time

INSTRUMENTS = [
    "bass", "brass", "flute", "guitar", "keyboard", "mallet",
    "organ", "reed", "string", "synth_lead", "vocal",
]

ABBREVS = {
    "length": "l",
    "layers": "lyr",
    "n_components": "cpn",
    "examples": "ex",
    "epochs": "ep",
    "qualities": "qult",
    "lambd": "lbd",
    "batch_size": "btch",
    "stack": "stk",
}


def gt_s_path(suppath: str, **kwargs) -> str:
    """Build (and create) a parameter-encoded run directory (utils.py:18-64)."""
    path = ""
    for name, value in sorted(kwargs.items()):
        if name == "ins" and value is not None:
            assert len(value) == 2
            path += f"{INSTRUMENTS[value[0]]}2{INSTRUMENTS[value[1]]}_"
        elif name == "male2female":
            assert value <= 2
            if value == 0:
                path += "f2m_"
            elif value == 1:
                path += "m2f_"
        elif name == "filename":
            path = f"{value}_{path}"
        elif name == "cont_fn":
            path += f"_cnt_{value}_"
        elif name == "style_fn":
            path += f"_style_{value}_"
        elif name == "gatys":
            path = ("gatys_" if value else "ours_") + path
        elif name == "sr":
            path += f"_sr{value / 1000}kHz_"
        elif not name.endswith(("dir", "path", "pieces")) and value is not None:
            name = ABBREVS.get(name, name)
            if isinstance(value, (list, tuple)):
                value = "".join(f"-{int(v)}" for v in value)
            path += f"_{name}_{value}_"

    path = os.path.join(suppath, path)
    os.makedirs(path, exist_ok=True)
    return path


def crt_t_fol(suppath: str, hour: bool = False) -> str:
    """Date-named subfolder, e.g. ``<suppath>/816`` for Aug 16 (utils.py:67-76)."""
    dte = time.localtime()
    if hour:
        fol_n = os.path.join(suppath, f"{dte[1]}{dte[2]}{dte[3]}{dte[4]}")
    else:
        fol_n = os.path.join(suppath, f"{dte[1]}{dte[2]}")
    os.makedirs(fol_n, exist_ok=True)
    return fol_n
