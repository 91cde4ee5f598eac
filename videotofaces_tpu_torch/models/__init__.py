"""Models: the MTCNN detector (PNet / RNet / ONet ``nn.Module``s, NCHW,
float32 params) and its cascade."""
