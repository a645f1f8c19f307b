"""Model zoo of the port: the counterpart of ``repro.models`` (the dense
family so far)."""
