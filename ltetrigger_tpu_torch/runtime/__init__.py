"""runtime: host-side state around the engine.

The port's own copies of ltetrigger_tpu/runtime's numpy-only modules:
`cellstore` (the tracked-cell registry) and `chunkbuf` (the streaming chunk
accumulator).  `native` (the C++ front end's binding) is not copied yet.
"""
