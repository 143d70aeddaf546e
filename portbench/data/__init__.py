"""The benchmark's own inputs, made on the device from the seed."""
