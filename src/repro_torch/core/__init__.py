"""Host build plane and batched device query plane of the port."""
