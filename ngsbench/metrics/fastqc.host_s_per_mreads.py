"""fastqc.host_s_per_mreads: the walls of fastqc's host stages (parse,
placement, tile_names*, render*, dedup, dup_render) summed over the traced
window's calls, from each call's NGSTPU_STAGE_JSON, per million reads."""

HOST = ("parse", "placement", "tile_names", "render", "dedup", "dup_render")


def read(ctx):
    if not ctx.stages:
        return None
    calls = [c for c in ctx.calls if c["index"] in ctx.stages]
    wall = sum(v for c in calls for k, v in ctx.stages[c["index"]].items()
               if k.rstrip("0123456789") in HOST)
    return wall / (sum(c["reads"] for c in calls) / 1e6)
