"""The drivers of the kinds of traffic. A mix's ``kind`` names one.

Each module defines ``small(cfg, traffic)``, the configuration and mix cut
to a size the CPU runs in seconds (the harness's tests), and
``Workload(cell, seed, device)`` with
  setup()            everything before the window: weights, traffic, warm-up
  run_window(s)      units of work (clips, steps) until ``s`` seconds passed
  end_to_end()       {metric: value} of the window
  install_spans() / span_readings() / uninstall_spans()   (traced run)
  profile_unit()     one more unit, run under the caller's profiler; returns
                     its count of evaluations or steps
  trace_context()    what the per-layer readers need beside the trace
  free()             drop the program's state
  readings()         {number: value} compared against the cell's limits
"""
