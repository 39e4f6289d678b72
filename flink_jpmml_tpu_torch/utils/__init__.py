"""Host utilities of the port: errors, configs, metrics, device policy."""
