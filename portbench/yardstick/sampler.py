"""Frozen work counts of the texture sampler, forward and backward: the
least the card could move for it, whatever kernel computes it.

Counted per covered pixel (a pixel whose winner is a face): the winner's
texel-coordinate triangle (6 floats), vertex depths (3) and weights (3)
read; four taps of three channels read; the RGB (3) written; the RGB's
gradient (3) read; four taps of three channels added at their texels.
Counted once per object, not per view: the atlas (3 channels) read and
its gradient written.  So a sampler that adds every view's taps into one
atlas gradient, in place of one a view summed after, is held to the same
count.  The operations are the taps' arithmetic only (forward: a
multiply and an add per tap and channel; backward: the tap's gradient
and its add), a floor: the bound is the bytes'.
"""

from __future__ import annotations

FLOAT = 4
# floats a covered pixel reads or writes (see above)
PIXEL_FLOATS = 6 + 3 + 3 + 4 * 3 + 3 + 3 + 4 * 3
# float operations a covered pixel does (see above)
PIXEL_OPS = 2 * 4 * 3 + 2 * 4 * 3


def sample_work(covered, objects, texels):
    """(bytes, operations) of the sampler's forward and backward over
    ``covered`` pixels, for ``objects`` atlases of ``texels`` texels of
    three channels each."""
    atlas_bytes = 2 * objects * 3 * texels * FLOAT
    return covered * PIXEL_FLOATS * FLOAT + atlas_bytes, covered * PIXEL_OPS
