"""Device execution: segment blocks, the expression library (device and host
evaluators, and the datetime, string, JSON and geo functions), the
aggregation body and the CUDA scan kernels."""
