"""Data (counterpart of :mod:`calciumgan_tpu.data`): the TFRecord codec,
dataset loading, batches on the device and reverse preprocessing."""
