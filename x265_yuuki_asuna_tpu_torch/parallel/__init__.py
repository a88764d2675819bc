"""Multi-slot parallel strategies: pipeline slots (streams on the cards)
and the frame-parallel, slice-band and P-chain pipeline programs. See
parallel/mesh.py."""

from .mesh import make_slots, frame_parallel_fn, band_parallel_fn  # noqa: F401
from .pipeline import (frame_pipeline_fn,  # noqa: F401
                       frame_pipeline_stream_fn)
