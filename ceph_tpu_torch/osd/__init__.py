"""OSD tier: stripe math and whole-object EC encode/decode (ecutil)."""
