"""Host data layer of the port: the raw PCM-16 WAV reader
(:mod:`.wavio`)."""
