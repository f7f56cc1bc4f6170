"""Serving: the paged KV cache, the paged attention kernels and the engine.

Import the engine as ``serving.engine``; this package's ``__init__``
imports nothing, so ``models.cached`` and the engine can import each
other's modules in any order.
"""
