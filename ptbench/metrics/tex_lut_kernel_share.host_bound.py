"""100 x the texture pair tables that the program's CUDA kernel baked over
all the pair tables it baked: the counters `tex_lut_bakes_kernel` and
`tex_lut_bakes`, summed over the window, in %. None without the counters: a
`--trace 0` run, a cell whose scene bakes no pair table, or a program that
does not count them."""


def read(run):
    c = run.program_counters or {}
    if not c.get("tex_lut_bakes"):
        return None
    return 100.0 * c.get("tex_lut_bakes_kernel", 0) / c["tex_lut_bakes"]
