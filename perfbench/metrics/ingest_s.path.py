"""A fit's time outside its lambda loop, s: the fit's wall on the host
clock minus `stats["wall_time_s"]` (the port's own span of the path),
averaged over the window's fits; ingestion, standardization, the split,
the packing, the step sizes and the rescale."""


def read(ctx):
    fits = ctx.get("fits") if ctx.get("kind") == "fits" else None
    if not fits:
        return None
    return sum(f["wall_s"] - f["path_s"] for f in fits) / len(fits)
