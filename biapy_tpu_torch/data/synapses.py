"""Synapse channel-set selector, copied from the JAX package's
``data/synapses.py`` for the configuration checks. The synapse workflow
itself is not ported yet.
"""

from __future__ import annotations

from typing import Sequence


def select_synapse_method(channels: Sequence[str]) -> str:
    """Channel set -> synapse method (reference: instance_seg.py:224-234)."""
    ch = list(channels)
    if set(ch) == {"F_pre", "F_post"} and len(ch) == 2:
        return "simpsyn"
    if set(ch) == {"F_post", "Z", "V", "H"} and len(ch) == 4:
        return "synful"
    if ch == ["F_cleft"]:
        return "cleft"
    if ch == ["F_post"]:
        return "F_post_only"
    raise ValueError(f"Unknown synapse prediction method for channels {channels}")
