"""100 x the texture feeds that the program's CUDA kernel served over all
its texture feeds: the counters `tex_feeds_kernel` and `tex_feeds`, summed
over the window, in %. None without the counters: a `--trace 0` run, a
cell whose route feeds no texture, or a program that does not count them."""


def read(run):
    c = run.program_counters or {}
    if not c.get("tex_feeds"):
        return None
    return 100.0 * c.get("tex_feeds_kernel", 0) / c["tex_feeds"]
