"""Epochs a fit ran over its whole path (`stats["epochs"]`, the port's
count, every halved-step retry included), averaged over the window's fits."""


def read(ctx):
    fits = ctx.get("fits") if ctx.get("kind") == "fits" else None
    if not fits:
        return None
    return sum(f["epochs"] for f in fits) / len(fits)
