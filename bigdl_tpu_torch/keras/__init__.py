"""bigdl_tpu_torch.keras — Keras-1.2.2-style API (port of
``bigdl_tpu/keras``; SURVEY.md §2.3 nn/keras/).

Reference: nn/keras/Topology.scala:35-262 (KerasModel with
compile/fit/evaluate/predict as sugar over the Optimizer, Appendix B.11)
and the 71 shape-inferred layer wrappers. Each ``KerasLayer`` lazily
builds the underlying nn module on its ``device`` (default the card) once
the input shape is known; shapes come from running the built module
(``keras/engine.py`` says how, and why it leaves the model untouched).
``converter.py`` loads Keras json topologies and hdf5 weights
(``load_keras``).
"""

from bigdl_tpu_torch.keras.engine import KerasLayer, InputLayer
from bigdl_tpu_torch.keras.topology import Sequential, Model
from bigdl_tpu_torch.keras.layers import (
    Dense, Activation, Dropout, Flatten, Reshape, Permute, RepeatVector,
    Masking, Highway, MaxoutDense,
    Convolution1D, Convolution2D, SeparableConvolution2D, Deconvolution2D,
    AtrousConvolution2D, LocallyConnected2D,
    MaxPooling1D, MaxPooling2D, AveragePooling1D, AveragePooling2D,
    GlobalAveragePooling1D, GlobalAveragePooling2D, GlobalMaxPooling1D,
    GlobalMaxPooling2D,
    BatchNormalization, Embedding, GaussianNoise, GaussianDropout,
    SpatialDropout1D, SpatialDropout2D,
    LSTM, GRU, SimpleRNN, Bidirectional, TimeDistributed,
    Merge, ZeroPadding1D, ZeroPadding2D, Cropping1D, Cropping2D,
    UpSampling1D, UpSampling2D, LeakyReLU, ELU, PReLU, SReLU,
    ThresholdedReLU,
    Convolution3D, MaxPooling3D, AveragePooling3D, GlobalMaxPooling3D,
    GlobalAveragePooling3D, Cropping3D, ZeroPadding3D, UpSampling3D,
    SpatialDropout3D, AtrousConvolution1D, LocallyConnected1D, ConvLSTM2D,
    SoftMax, Input,
)
