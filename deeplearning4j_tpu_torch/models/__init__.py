"""Models of the port: BERT inference so far."""
from deeplearning4j_tpu_torch.models.bert import (BertConfig, bert_base,
                                                  bert_classify,
                                                  bert_encode,
                                                  bert_mlm_logits,
                                                  bert_pooled, bert_tiny)
from deeplearning4j_tpu_torch.models.convert import (init_bert_params,
                                                     params_from_numpy,
                                                     params_to_numpy)

__all__ = ["BertConfig", "bert_base", "bert_tiny", "bert_encode",
           "bert_pooled", "bert_classify", "bert_mlm_logits",
           "init_bert_params", "params_from_numpy", "params_to_numpy"]
