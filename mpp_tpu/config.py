"""Config ingestion: minimal Fortran-namelist parser + option registry.

The reference drives every standalone problem from Fortran namelists
(``standalone_mpp.F90:69-123``) plus PETSc CLI options.  For regression
parity we ingest the same ``.namelist`` files directly.
"""
from __future__ import annotations

import re
from typing import Any, Dict


def _parse_value(tok: str) -> Any:
    tok = tok.strip()
    if tok.startswith("'") or tok.startswith('"'):
        return tok.strip("'\"")
    low = tok.lower()
    if low in (".true.", "t", ".t."):
        return True
    if low in (".false.", "f", ".f."):
        return False
    tok_f = re.sub(r"[dD]", "e", tok)
    try:
        if re.fullmatch(r"[+-]?\d+", tok):
            return int(tok)
        return float(tok_f)
    except ValueError:
        return tok


def read_namelist(path_or_text: str) -> Dict[str, Dict[str, Any]]:
    """Parse groups ``&name ... /`` into {group: {key: value}}."""
    if "\n" in path_or_text or "&" in path_or_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    groups: Dict[str, Dict[str, Any]] = {}
    cur = None
    for raw in text.splitlines():
        line = raw.split("!")[0].strip()
        if not line:
            continue
        if line.startswith("&"):
            cur = {}
            groups[line[1:].strip().lower()] = cur
            continue
        if line.startswith("/"):
            cur = None
            continue
        if cur is not None and "=" in line:
            key, val = line.split("=", 1)
            vals = [v for v in re.split(r"[,\s]+", val.strip()) if v]
            if len(vals) == 1:
                cur[key.strip().lower()] = _parse_value(vals[0])
            else:
                cur[key.strip().lower()] = [_parse_value(v) for v in vals]
    return groups


def enable_nan_debug(mode: str = "debug_nans") -> None:
    """NaN-debugging hook (SURVEY §5 sanitizers row).

    ``debug_nans``: turn on ``jax_debug_nans`` — any NaN produced inside
    a jitted computation raises immediately with a de-optimized re-run
    pinpointing the primitive (the analog of ``-fpe trap`` builds).
    ``disable``: turn it back off.
    """
    import jax
    if mode == "debug_nans":
        jax.config.update("jax_debug_nans", True)
    elif mode == "disable":
        jax.config.update("jax_debug_nans", False)
    else:
        raise ValueError(f"unknown NaN-debug mode '{mode}'")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache lives at the fixed
    ``<repo>/.jax_cache`` (gitignored): the path is part of the cache
    key, so a directory that moves never hits."""
    import os
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cache = os.path.join(repo, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", cache)
    return cache


def maybe_enable_nan_debug_from_env() -> bool:
    """Honor MPP_DEBUG_NANS=1 (also checked by the CLI's --debug-nans)."""
    import os
    if os.environ.get("MPP_DEBUG_NANS", "") not in ("", "0", "false"):
        enable_nan_debug()
        return True
    return False
