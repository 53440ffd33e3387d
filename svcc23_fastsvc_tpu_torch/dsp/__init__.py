"""Signal processing: F0 (YIN on the device, Harvest on the host, log-F0
statistics and conversion), silence trimming, and the vocoder's dilation
factors."""
