"""Signal processing: F0 (YIN on the device, Harvest on the host, log-F0
statistics and conversion), silence trimming, the vocoder's dilation
factors, and the B02 recipe's WORLD analysis (mcep, band aperiodicity,
continuous log-F0)."""
