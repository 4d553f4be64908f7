"""The benchmark's yardstick: discovery by name, input generators, the
measured window, the trace reduction, the work counts and the plain
reference. Only ``window``, ``cell`` and the entries touch the port."""
