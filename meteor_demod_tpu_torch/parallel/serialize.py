"""Row packing shared by the fleet state mirror (mesh.py state_dict /
restore_state) and the checkpoint file layer (io/checkpoint.py).

Symbol-row dicts (sym_re/sym_im/valid/locked_once arrays) are stored
concatenated: row boundaries are not semantic — every consumer concatenates
them anyway."""

from __future__ import annotations

import numpy as np

ROW_KEYS = ("sym_re", "sym_im", "valid", "locked_once")


def pack_rows(rows: list, arrays: dict, prefix: str) -> int:
    for k in ROW_KEYS:
        arrays[f"{prefix}{k}"] = (
            np.concatenate([np.asarray(r[k]) for r in rows]) if rows
            else np.zeros(0, np.float32 if k.startswith("sym")
                          else np.int32))
    return len(rows)


def unpack_rows(z, prefix: str) -> list:
    if f"{prefix}valid" not in z.files or not len(z[f"{prefix}valid"]):
        return []
    return [{k: np.asarray(z[f"{prefix}{k}"]) for k in ROW_KEYS}]
