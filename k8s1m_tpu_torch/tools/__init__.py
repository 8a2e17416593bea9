"""Entry points of the port: ``sched_bench`` (store -> watch -> wave ->
CAS bind, end to end), ``kernel_probe``, ``megarow_drill`` (the
1,048,576-node headline run) and ``make_nodes.build_node``."""
