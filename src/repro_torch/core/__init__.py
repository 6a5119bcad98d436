"""SparKV's scheduling core: chunk grid, costs, scheduler, controller,
discrete-event engine (copies of ``repro.core``), the latency predictor
(torch MLP) and the loading pipelines."""
