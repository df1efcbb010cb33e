"""Host-side numpy replay storage and its staging to the device (counterpart of ``sheeprl_tpu/data``)."""
