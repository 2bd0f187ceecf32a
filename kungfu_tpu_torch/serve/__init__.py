"""The serving plane of the port: paged KV pool, SLO metrics and the
continuous-batching engine.  Importing it builds nothing and touches no
GPU; the router and serve worker (multi-peer serving) come later."""
