"""Host utilities: weight bundles and their msgpack codec, parameter conversion, metrics and image output."""
