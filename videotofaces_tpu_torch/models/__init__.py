"""Models: the MTCNN detector (PNet / RNet / ONet ``nn.Module``s and the
cascade), the Faster R-CNN detector (ResNet-50 + FPN + RPN + RoI head), the
FaceNet encoder (InceptionResnetV1) and the ViT encoder; NCHW, float32
params."""
