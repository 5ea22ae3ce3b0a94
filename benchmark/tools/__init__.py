"""Tools of the benchmark that its own runs never call: the blank-bias chooser and the readings the limits are set from."""
