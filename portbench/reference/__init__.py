"""The plain references, one module per architecture.

A configuration file may name its own, ``"reference": "<stem>"``:
``reference/<stem>.py`` beside this file, in the portbench directory
the cell's files came from.  That module defines

- ``draw(cfg, seed, device)``: the function's weights, drawn again from
  its seed bit for bit as the program draws them;
- ``logits(cfg, params, tokens, positions, *, prefill_len, fp8=False)``:
  float32 logits with TF32 off, and the fp8 control with ``fp8=True``;

as ``weights.draw`` and ``model.logits`` do, and may define any of
``body_params``, ``attn_flops``, ``flash_call`` and ``decode_call``
with the signatures of ``metrics/counts.py``, which then counts that
configuration's work with them.  A file without the key is checked by
``weights.draw`` and ``model.logits`` and counted by ``counts.py``
alone.  Nothing here imports the program.
"""

from __future__ import annotations

from pathlib import Path

HERE = Path(__file__).resolve().parent
FILE_KEY = "_reference_file"  # set by ``bench.Cell``: the module's path
_loaded: dict = {}


def module(cfg: dict):
    """The configuration's own reference module, loaded once a file, or
    None where its file names none: ``cfg[FILE_KEY]`` where the cell put
    it there, else ``<stem>.py`` beside this file.  It has to define
    ``draw`` and ``logits``."""
    if FILE_KEY in cfg:
        p = Path(cfg[FILE_KEY])
    elif "reference" in cfg:
        p = HERE / f"{cfg['reference']}.py"
    else:
        return None
    if p not in _loaded:
        if not p.exists():
            raise SystemExit(f"portbench: {cfg['name']} names the "
                             f"reference {p}, which is not there")
        from portbench.bench import load_module
        mod = load_module(p)
        missing = [f for f in ("draw", "logits") if not hasattr(mod, f)]
        if missing:
            raise SystemExit(f"portbench: the reference {p} defines no "
                             f"{missing}")
        _loaded[p] = mod
    return _loaded[p]
