"""Design generators, one module a configuration's `data_kind`."""
