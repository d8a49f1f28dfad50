# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: service.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rservice.proto\x12\x13karpenter.solver.v1\"B\n\x06Tensor\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05\x64type\x18\x02 \x01(\t\x12\r\n\x05shape\x18\x03 \x03(\x03\x12\x0c\n\x04\x64\x61ta\x18\x04 \x01(\x0c\"N\n\x0cSolveRequest\x12\x10\n\x08geometry\x18\x01 \x01(\t\x12,\n\x07tensors\x18\x02 \x03(\x0b\x32\x1b.karpenter.solver.v1.Tensor\"L\n\rSolveResponse\x12,\n\x07tensors\x18\x01 \x03(\x0b\x32\x1b.karpenter.solver.v1.Tensor\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"\x0f\n\rHealthRequest\"@\n\x0eHealthResponse\x12\x0e\n\x06status\x18\x01 \x01(\t\x12\x0e\n\x06\x64\x65vice\x18\x02 \x01(\t\x12\x0e\n\x06solves\x18\x03 \x01(\x03\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'service_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TENSOR._serialized_start=38
  _TENSOR._serialized_end=104
  _SOLVEREQUEST._serialized_start=106
  _SOLVEREQUEST._serialized_end=184
  _SOLVERESPONSE._serialized_start=186
  _SOLVERESPONSE._serialized_end=262
  _HEALTHREQUEST._serialized_start=264
  _HEALTHREQUEST._serialized_end=279
  _HEALTHRESPONSE._serialized_start=281
  _HEALTHRESPONSE._serialized_end=345
# @@protoc_insertion_point(module_scope)
