"""The texture feed's kernel share on synthetic program counters."""

import pytest

from ptbench import run as R


def read(counters):
    run = R.Run({"width": 10, "height": 10, "samples": 2})
    run.program_counters = counters
    return R.load_metric("tex_feed_kernel_share.host_bound").read(run)


@pytest.mark.parametrize("counters,share", [
    (dict(tex_feeds=67, tex_feeds_kernel=67), 100.0),
    (dict(tex_feeds=80, tex_feeds_kernel=20), 25.0),
    (dict(tex_feeds=67, tex_feeds_kernel=0), 0.0),
    (dict(tex_feeds=67), 0.0),
    (dict(lanes_launched=8192, lanes_live=2048.0), None),
    (None, None)],
    ids=["all", "a_quarter", "none", "no_kernel_count", "no_feed",
         "untraced"])
def test_tex_feed_kernel_share(counters, share):
    got = read(counters)
    assert got == (None if share is None else pytest.approx(share))
