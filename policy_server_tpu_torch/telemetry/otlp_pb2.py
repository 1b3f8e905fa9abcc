# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: otlp.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\notlp.proto\x12\x11policyserver.otlp\"\xf4\x01\n\x08\x41nyValue\x12\x16\n\x0cstring_value\x18\x01 \x01(\tH\x00\x12\x14\n\nbool_value\x18\x02 \x01(\x08H\x00\x12\x13\n\tint_value\x18\x03 \x01(\x03H\x00\x12\x16\n\x0c\x64ouble_value\x18\x04 \x01(\x01H\x00\x12\x34\n\x0b\x61rray_value\x18\x05 \x01(\x0b\x32\x1d.policyserver.otlp.ArrayValueH\x00\x12\x37\n\x0ckvlist_value\x18\x06 \x01(\x0b\x32\x1f.policyserver.otlp.KeyValueListH\x00\x12\x15\n\x0b\x62ytes_value\x18\x07 \x01(\x0cH\x00\x42\x07\n\x05value\"9\n\nArrayValue\x12+\n\x06values\x18\x01 \x03(\x0b\x32\x1b.policyserver.otlp.AnyValue\";\n\x0cKeyValueList\x12+\n\x06values\x18\x01 \x03(\x0b\x32\x1b.policyserver.otlp.KeyValue\"C\n\x08KeyValue\x12\x0b\n\x03key\x18\x01 \x01(\t\x12*\n\x05value\x18\x02 \x01(\x0b\x32\x1b.policyserver.otlp.AnyValue\"\x88\x01\n\x14InstrumentationScope\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\x12/\n\nattributes\x18\x03 \x03(\x0b\x32\x1b.policyserver.otlp.KeyValue\x12 \n\x18\x64ropped_attributes_count\x18\x04 \x01(\r\"]\n\x08Resource\x12/\n\nattributes\x18\x01 \x03(\x0b\x32\x1b.policyserver.otlp.KeyValue\x12 \n\x18\x64ropped_attributes_count\x18\x02 \x01(\r\"\x86\x01\n\rResourceSpans\x12-\n\x08resource\x18\x01 \x01(\x0b\x32\x1b.policyserver.otlp.Resource\x12\x32\n\x0bscope_spans\x18\x02 \x03(\x0b\x32\x1d.policyserver.otlp.ScopeSpans\x12\x12\n\nschema_url\x18\x03 \x01(\t\"\x80\x01\n\nScopeSpans\x12\x36\n\x05scope\x18\x01 \x01(\x0b\x32\'.policyserver.otlp.InstrumentationScope\x12&\n\x05spans\x18\x02 \x03(\x0b\x32\x17.policyserver.otlp.Span\x12\x12\n\nschema_url\x18\x03 \x01(\t\"\x96\x07\n\x04Span\x12\x10\n\x08trace_id\x18\x01 \x01(\x0c\x12\x0f\n\x07span_id\x18\x02 \x01(\x0c\x12\x13\n\x0btrace_state\x18\x03 \x01(\t\x12\x16\n\x0eparent_span_id\x18\x04 \x01(\x0c\x12\x0c\n\x04name\x18\x05 \x01(\t\x12.\n\x04kind\x18\x06 \x01(\x0e\x32 .policyserver.otlp.Span.SpanKind\x12\x1c\n\x14start_time_unix_nano\x18\x07 \x01(\x06\x12\x1a\n\x12\x65nd_time_unix_nano\x18\x08 \x01(\x06\x12/\n\nattributes\x18\t \x03(\x0b\x32\x1b.policyserver.otlp.KeyValue\x12 \n\x18\x64ropped_attributes_count\x18\n \x01(\r\x12-\n\x06\x65vents\x18\x0b \x03(\x0b\x32\x1d.policyserver.otlp.Span.Event\x12\x1c\n\x14\x64ropped_events_count\x18\x0c \x01(\r\x12+\n\x05links\x18\r \x03(\x0b\x32\x1c.policyserver.otlp.Span.Link\x12\x1b\n\x13\x64ropped_links_count\x18\x0e \x01(\r\x12)\n\x06status\x18\x0f \x01(\x0b\x32\x19.policyserver.otlp.Status\x1a\x80\x01\n\x05\x45vent\x12\x16\n\x0etime_unix_nano\x18\x01 \x01(\x06\x12\x0c\n\x04name\x18\x02 \x01(\t\x12/\n\nattributes\x18\x03 \x03(\x0b\x32\x1b.policyserver.otlp.KeyValue\x12 \n\x18\x64ropped_attributes_count\x18\x04 \x01(\r\x1a\x91\x01\n\x04Link\x12\x10\n\x08trace_id\x18\x01 \x01(\x0c\x12\x0f\n\x07span_id\x18\x02 \x01(\x0c\x12\x13\n\x0btrace_state\x18\x03 \x01(\t\x12/\n\nattributes\x18\x04 \x03(\x0b\x32\x1b.policyserver.otlp.KeyValue\x12 \n\x18\x64ropped_attributes_count\x18\x05 \x01(\r\"\x99\x01\n\x08SpanKind\x12\x19\n\x15SPAN_KIND_UNSPECIFIED\x10\x00\x12\x16\n\x12SPAN_KIND_INTERNAL\x10\x01\x12\x14\n\x10SPAN_KIND_SERVER\x10\x02\x12\x14\n\x10SPAN_KIND_CLIENT\x10\x03\x12\x16\n\x12SPAN_KIND_PRODUCER\x10\x04\x12\x16\n\x12SPAN_KIND_CONSUMER\x10\x05\"\x9d\x01\n\x06Status\x12\x0f\n\x07message\x18\x02 \x01(\t\x12\x32\n\x04\x63ode\x18\x03 \x01(\x0e\x32$.policyserver.otlp.Status.StatusCode\"N\n\nStatusCode\x12\x15\n\x11STATUS_CODE_UNSET\x10\x00\x12\x12\n\x0eSTATUS_CODE_OK\x10\x01\x12\x15\n\x11STATUS_CODE_ERROR\x10\x02\"\x8c\x01\n\x0fResourceMetrics\x12-\n\x08resource\x18\x01 \x01(\x0b\x32\x1b.policyserver.otlp.Resource\x12\x36\n\rscope_metrics\x18\x02 \x03(\x0b\x32\x1f.policyserver.otlp.ScopeMetrics\x12\x12\n\nschema_url\x18\x03 \x01(\t\"\x86\x01\n\x0cScopeMetrics\x12\x36\n\x05scope\x18\x01 \x01(\x0b\x32\'.policyserver.otlp.InstrumentationScope\x12*\n\x07metrics\x18\x02 \x03(\x0b\x32\x19.policyserver.otlp.Metric\x12\x12\n\nschema_url\x18\x03 \x01(\t\"\xc6\x01\n\x06Metric\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x13\n\x0b\x64\x65scription\x18\x02 \x01(\t\x12\x0c\n\x04unit\x18\x03 \x01(\t\x12)\n\x05gauge\x18\x05 \x01(\x0b\x32\x18.policyserver.otlp.GaugeH\x00\x12%\n\x03sum\x18\x07 \x01(\x0b\x32\x16.policyserver.otlp.SumH\x00\x12\x31\n\thistogram\x18\t \x01(\x0b\x32\x1c.policyserver.otlp.HistogramH\x00\x42\x06\n\x04\x64\x61ta\"@\n\x05Gauge\x12\x37\n\x0b\x64\x61ta_points\x18\x01 \x03(\x0b\x32\".policyserver.otlp.NumberDataPoint\"\xa0\x01\n\x03Sum\x12\x37\n\x0b\x64\x61ta_points\x18\x01 \x03(\x0b\x32\".policyserver.otlp.NumberDataPoint\x12J\n\x17\x61ggregation_temporality\x18\x02 \x01(\x0e\x32).policyserver.otlp.AggregationTemporality\x12\x14\n\x0cis_monotonic\x18\x03 \x01(\x08\"\x93\x01\n\tHistogram\x12:\n\x0b\x64\x61ta_points\x18\x01 \x03(\x0b\x32%.policyserver.otlp.HistogramDataPoint\x12J\n\x17\x61ggregation_temporality\x18\x02 \x01(\x0e\x32).policyserver.otlp.AggregationTemporality\"\xb7\x01\n\x0fNumberDataPoint\x12\x1c\n\x14start_time_unix_nano\x18\x02 \x01(\x06\x12\x16\n\x0etime_unix_nano\x18\x03 \x01(\x06\x12\x13\n\tas_double\x18\x04 \x01(\x01H\x00\x12\x10\n\x06\x61s_int\x18\x06 \x01(\x10H\x00\x12/\n\nattributes\x18\x07 \x03(\x0b\x32\x1b.policyserver.otlp.KeyValue\x12\r\n\x05\x66lags\x18\x08 \x01(\rB\x07\n\x05value\"\x97\x02\n\x12HistogramDataPoint\x12\x1c\n\x14start_time_unix_nano\x18\x02 \x01(\x06\x12\x16\n\x0etime_unix_nano\x18\x03 \x01(\x06\x12\r\n\x05\x63ount\x18\x04 \x01(\x06\x12\x10\n\x03sum\x18\x05 \x01(\x01H\x00\x88\x01\x01\x12\x15\n\rbucket_counts\x18\x06 \x03(\x06\x12\x17\n\x0f\x65xplicit_bounds\x18\x07 \x03(\x01\x12/\n\nattributes\x18\t \x03(\x0b\x32\x1b.policyserver.otlp.KeyValue\x12\r\n\x05\x66lags\x18\n \x01(\r\x12\x10\n\x03min\x18\x0b \x01(\x01H\x01\x88\x01\x01\x12\x10\n\x03max\x18\x0c \x01(\x01H\x02\x88\x01\x01\x42\x06\n\x04_sumB\x06\n\x04_minB\x06\n\x04_max\"U\n\x19\x45xportTraceServiceRequest\x12\x38\n\x0eresource_spans\x18\x01 \x03(\x0b\x32 .policyserver.otlp.ResourceSpans\"J\n\x19\x45xportTracePartialSuccess\x12\x16\n\x0erejected_spans\x18\x01 \x01(\x03\x12\x15\n\rerror_message\x18\x02 \x01(\t\"c\n\x1a\x45xportTraceServiceResponse\x12\x45\n\x0fpartial_success\x18\x01 \x01(\x0b\x32,.policyserver.otlp.ExportTracePartialSuccess\"[\n\x1b\x45xportMetricsServiceRequest\x12<\n\x10resource_metrics\x18\x01 \x03(\x0b\x32\".policyserver.otlp.ResourceMetrics\"R\n\x1b\x45xportMetricsPartialSuccess\x12\x1c\n\x14rejected_data_points\x18\x01 \x01(\x03\x12\x15\n\rerror_message\x18\x02 \x01(\t\"g\n\x1c\x45xportMetricsServiceResponse\x12G\n\x0fpartial_success\x18\x01 \x01(\x0b\x32..policyserver.otlp.ExportMetricsPartialSuccess*\x8c\x01\n\x16\x41ggregationTemporality\x12\'\n#AGGREGATION_TEMPORALITY_UNSPECIFIED\x10\x00\x12!\n\x1d\x41GGREGATION_TEMPORALITY_DELTA\x10\x01\x12&\n\"AGGREGATION_TEMPORALITY_CUMULATIVE\x10\x02\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'otlp_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _AGGREGATIONTEMPORALITY._serialized_start=3927
  _AGGREGATIONTEMPORALITY._serialized_end=4067
  _ANYVALUE._serialized_start=34
  _ANYVALUE._serialized_end=278
  _ARRAYVALUE._serialized_start=280
  _ARRAYVALUE._serialized_end=337
  _KEYVALUELIST._serialized_start=339
  _KEYVALUELIST._serialized_end=398
  _KEYVALUE._serialized_start=400
  _KEYVALUE._serialized_end=467
  _INSTRUMENTATIONSCOPE._serialized_start=470
  _INSTRUMENTATIONSCOPE._serialized_end=606
  _RESOURCE._serialized_start=608
  _RESOURCE._serialized_end=701
  _RESOURCESPANS._serialized_start=704
  _RESOURCESPANS._serialized_end=838
  _SCOPESPANS._serialized_start=841
  _SCOPESPANS._serialized_end=969
  _SPAN._serialized_start=972
  _SPAN._serialized_end=1890
  _SPAN_EVENT._serialized_start=1458
  _SPAN_EVENT._serialized_end=1586
  _SPAN_LINK._serialized_start=1589
  _SPAN_LINK._serialized_end=1734
  _SPAN_SPANKIND._serialized_start=1737
  _SPAN_SPANKIND._serialized_end=1890
  _STATUS._serialized_start=1893
  _STATUS._serialized_end=2050
  _STATUS_STATUSCODE._serialized_start=1972
  _STATUS_STATUSCODE._serialized_end=2050
  _RESOURCEMETRICS._serialized_start=2053
  _RESOURCEMETRICS._serialized_end=2193
  _SCOPEMETRICS._serialized_start=2196
  _SCOPEMETRICS._serialized_end=2330
  _METRIC._serialized_start=2333
  _METRIC._serialized_end=2531
  _GAUGE._serialized_start=2533
  _GAUGE._serialized_end=2597
  _SUM._serialized_start=2600
  _SUM._serialized_end=2760
  _HISTOGRAM._serialized_start=2763
  _HISTOGRAM._serialized_end=2910
  _NUMBERDATAPOINT._serialized_start=2913
  _NUMBERDATAPOINT._serialized_end=3096
  _HISTOGRAMDATAPOINT._serialized_start=3099
  _HISTOGRAMDATAPOINT._serialized_end=3378
  _EXPORTTRACESERVICEREQUEST._serialized_start=3380
  _EXPORTTRACESERVICEREQUEST._serialized_end=3465
  _EXPORTTRACEPARTIALSUCCESS._serialized_start=3467
  _EXPORTTRACEPARTIALSUCCESS._serialized_end=3541
  _EXPORTTRACESERVICERESPONSE._serialized_start=3543
  _EXPORTTRACESERVICERESPONSE._serialized_end=3642
  _EXPORTMETRICSSERVICEREQUEST._serialized_start=3644
  _EXPORTMETRICSSERVICEREQUEST._serialized_end=3735
  _EXPORTMETRICSPARTIALSUCCESS._serialized_start=3737
  _EXPORTMETRICSPARTIALSUCCESS._serialized_end=3819
  _EXPORTMETRICSSERVICERESPONSE._serialized_start=3821
  _EXPORTMETRICSSERVICERESPONSE._serialized_end=3924
# @@protoc_insertion_point(module_scope)
