"""The benchmark harness: discovery (`spec`), inputs from the seed
(`inputs`), the window (`window`), the trace (`trace`), work from shapes
(`work`), the check (`check`) and one run (`core`)."""
