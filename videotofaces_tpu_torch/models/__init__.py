"""Models: the MTCNN detector (PNet / RNet / ONet ``nn.Module``s and the
cascade) and the FaceNet encoder (InceptionResnetV1); NCHW, float32
params."""
