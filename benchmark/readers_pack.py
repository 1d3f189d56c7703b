"""Reader of the march's packing: a training render whose epoch fills less
than ``PACK_FILL`` (0.9) of its sample slots runs the encode, the networks
and their backward on the filled slots alone, packed into one flat batch
(``envidr_tpu_torch/render/scene.py``, ``ops/marching.py:SlotPacking``).
The program counts ``march.pack.rows`` (the rows a packed render ran on,
its padding included) and ``march.pack.slots`` (N x K of the renders that
packed).  The reader returns None where the run holds nothing to read: an
untraced run, a program without these counters, or a run whose traced
renders all stayed dense."""

from __future__ import annotations

from benchmark import spans


def march_pack_share(run):
    """The rows the packed renders ran their per-sample work on, in percent
    of those renders' N x K slots, over the traced steps: 100 x
    ``march.pack.rows`` / ``march.pack.slots``.  Moves the cell's train
    rays/s."""
    rows, slots = spans._counted(run, "march.pack.rows"), spans._counted(run, "march.pack.slots")
    if rows is None or not slots[0]:
        return None
    return 100.0 * rows[0] / slots[0]
