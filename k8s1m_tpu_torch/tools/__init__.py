"""Entry points of the port: ``sched_bench`` (store -> watch -> wave ->
CAS bind, end to end) and ``make_nodes.build_node``."""
