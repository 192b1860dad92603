"""Analysis helpers of the port: the package-side campaign and runner
builders (trace.py) that the smokes and the tests share.

The counterpart of wtf_tpu/analysis.  Its rule engine and the jaxpr/HLO
lowerings it reads have no torch counterpart here yet."""
