"""Counterexample reconstruction for device-decided violations.

Neither device engine's frontier carries parent pointers. Instead the
device search keeps its chunk-entry frontiers (dense bitmaps, or the
sparse engine's decoded keys), and on an invalid verdict this module
replays just the failing tail on the host:

1. take the last snapshot at or before the dead row — the exact closed
   config set the device search had there: a chunk's entry, a spike
   mini-chunk's, or (the crash-dom bands' host-row executor) the dead
   row's own entry;
2. run the CPU oracle's closure (:func:`jepsen_tpu_torch.lin.cpu.search_rows`)
   from that set through the dead row, tracking linearization order;
3. emit ``final-paths``: for each config alive at the failure, its model
   state and the op path that reached it.

The replay is bounded by one chunk of return events (one row of a
sparse spike or of the host-row executor), whatever the history's
length.
"""

from __future__ import annotations

import numpy as np

from jepsen_tpu_torch.lin import cpu, dense
from jepsen_tpu_torch.lin.prepare import PackedHistory


def replay_configs(p: PackedHistory, configs: set, base: int,
                   dead_row: int, cancel=None) -> dict:
    """Run the CPU oracle's closure from a known config set at row
    ``base`` through ``dead_row``, tracking linearization order, and emit
    configs + final-paths at the death. Returns {} on a cancel (reporting
    is best-effort)."""
    if not configs:
        return {}
    order = {cfg: None for cfg in configs}
    try:
        cpu.search_rows(p, configs, order, base, dead_row + 1,
                        cancel=cancel)
    except cpu.Dead as d:
        return {"configs": cpu._decode_configs(p, d.seen, d.r),
                "final-paths": cpu._final_paths(p, d.seen, d.order)}
    except cpu.Cancelled:
        return {}
    # The tail replay survived where the device died: a disagreement
    # between engines — surface it rather than fabricate a path.
    return {"error": "tail replay disagrees with device verdict "
                     f"(rows {base}..{dead_row} survive on host)"}


def tail_replay(p: PackedHistory, nil_id: int, snapshots: list,
                dead_row: int, cancel=None) -> dict:
    """Dense-engine counterexample: decode the last chunk-entry bitmap at
    or before ``dead_row`` and replay the failing tail."""
    usable = [(b, F) for b, F in snapshots if b <= dead_row]
    if not usable:
        return {}
    base, F = usable[-1]
    configs = set(dense.decode_bitmap(F, nil_id))
    return replay_configs(p, configs, base, dead_row, cancel=cancel)


def tail_replay_sparse(p: PackedHistory, snapshots: list, dead_row: int,
                       cancel=None) -> dict:
    """Sparse-engine counterexample: snapshots are ``(base_row,
    bits[cap, NW], state[cap, S], count)`` frontiers (numpy) at a chunk's
    entry or at a host row's entry (one row of replay); decode the
    multi-word bitsets and replay the tail."""
    usable = [s for s in snapshots if s[0] <= dead_row]
    if not usable:
        return {}
    base, bits, state, count = usable[-1]
    n = min(int(count), np.asarray(bits).shape[0])
    bits = np.asarray(bits)[:n].astype(object)
    state = np.asarray(state)[:n]
    packed = bits[:, 0]
    for w in range(1, bits.shape[1]):
        packed = packed | (bits[:, w] << (32 * w))
    configs = set(zip((int(b) for b in packed),
                      map(tuple, state.tolist())))
    return replay_configs(p, configs, base, dead_row, cancel=cancel)
