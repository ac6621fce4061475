"""Signal generators: the traffic's IQ, made from the seed on the device."""
