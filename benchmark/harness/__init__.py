"""The benchmark's drivers, traffic generator, trace reduction and the arithmetic of operations and bytes."""
