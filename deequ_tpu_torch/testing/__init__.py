"""Test harnesses of the port: ``faults.FaultInjectingDataset``."""
