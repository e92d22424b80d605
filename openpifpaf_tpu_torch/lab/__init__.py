"""The Mosaic lab on the card: the fused-block design's primitives (lane
interleave, VALID 5x5 depthwise, branch2) as hand-written CUDA kernels (the
interleave its own, the other two modes of the backbone's depthwise and
fused-block kernels), timed alone at k16's stage geometries by
:mod:`.mosaic_lab`."""
