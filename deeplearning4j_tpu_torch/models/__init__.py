"""Models of the port: BERT inference and fine-tuning; the zoo's
ResNet-50 is in `models.zoo`."""
from deeplearning4j_tpu_torch.models.bert import (BertConfig, bert_base,
                                                  bert_classify,
                                                  bert_encode,
                                                  bert_mlm_logits,
                                                  bert_pooled, bert_tiny,
                                                  classification_loss)
from deeplearning4j_tpu_torch.models.convert import (init_bert_params,
                                                     param_leaves,
                                                     params_from_numpy,
                                                     params_to_numpy)

__all__ = ["BertConfig", "bert_base", "bert_tiny", "bert_encode",
           "bert_pooled", "bert_classify", "bert_mlm_logits",
           "classification_loss", "init_bert_params", "param_leaves",
           "params_from_numpy", "params_to_numpy"]
