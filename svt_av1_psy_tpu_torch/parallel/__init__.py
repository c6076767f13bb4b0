"""Host/device pipelining of the port."""
