"""utils: engineering-notation parsing and profiling helpers (the port's
own copies of ltetrigger_tpu/utils, with torch.profiler behind `trace` and
`annotate`, and the port's tracer, `profiling.span`)."""
