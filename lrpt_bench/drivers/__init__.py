"""One driver a traffic kind: it sets up the program, runs the measured
window and hands back what the metrics and the correctness check read."""
