"""Share of the traced window in which no operation ran on the device:
100 minus the union of the device records (stage markers left out) over
the window, averaged over the cards of the cell."""


def read(ctx):
    shares = [100.0 * (1.0 - busy / window)
              for busy, window in zip(ctx["busy_us"], ctx["window_us"]) if window]
    return sum(shares) / len(shares) if shares else None
