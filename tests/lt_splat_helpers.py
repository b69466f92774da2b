"""Helpers of the LT splat tests (`test_torch_lt_splat.py` on the CPU,
`test_torch_cuda.py` on the card): the rounds of `lt_trace_mega` recorded
as it runs them, and their splat entries. Imports no JAX."""

import torch

from pathtracer_tpu_torch.kernels import lt_mega as lt


def splat_entries(rounds, cs, v2):
    """(pixel id [M], XYZ [M, 3]) of every splat entry of the recorded
    rounds [(q, out, feed)], in the order the twins add them: per round the
    direct hits (none where q is None), then each camera sample's
    connections, then the light vertices (none where out is None)."""
    pids, xyzs = [], []
    for q, out, feed in rounds:
        fams = [] if q is None else [q[lt.Q_HIT_PID:lt.Q_HIT_XYZ + 3]]
        if out is not None:
            fams += [out[lt.K4_CONN + 4 * ci:lt.K4_CONN + 4 * ci + 4]
                     for ci in range(cs)]
            if v2:
                b = lt.k4_aux_v2(cs)["lv_pid"]
                fams.append(out[b:b + 4])
            else:
                fams.append(feed[lt.F_LV + 7:lt.F_LV + 11]
                            * out[lt.k4_aux(cs)["lv_ok"]])
        for f in fams:
            pids.append(f[0])
            xyzs.append(f[1:4].T)
    return torch.cat(pids), torch.cat(xyzs)


def splat_film(film, rounds, cs, v2):
    """A zero film like `film` with every splat entry of `rounds` (as
    `splat_entries` takes them) index-added."""
    pid, xyz = splat_entries(rounds, cs, v2)
    return torch.zeros_like(film).index_add_(0, pid.long(), xyz)


def record_rounds(monkeypatch):
    """Record each round's (q, out, feed) as `lt_trace_mega` runs it."""
    rounds, feeds = [], []
    feed_for = lt.spawn_feed_for

    def feed(*args):
        feeds.append(feed_for(*args))
        return feeds[-1]

    def wrap(step):
        def run(*args, **kw):
            out, q, counts = step(*args, **kw)
            rounds.append((q, out, feeds[-1] if feeds else None))
            return out, q, counts
        return run

    monkeypatch.setattr(lt, "spawn_feed_for", feed)
    monkeypatch.setattr(lt, "lt_round_v2", wrap(lt.lt_round_v2))
    monkeypatch.setattr(lt, "lt_round_v1", wrap(lt.lt_round_v1))
    return rounds
