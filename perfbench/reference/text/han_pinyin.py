"""Han-ideograph -> toneless-pinyin readings.

uroman romanizes Han via bundled megabyte-scale reading tables (reference
zerovox/tts/normalize.py:34 pipes through uroman). Neither uroman nor any
reading dataset is installable in this zero-egress environment, so this
module ships a compact frequency-ranked table: the ~2000 most frequent
simplified-Chinese characters (ranked by corpus frequency derived from the
jieba dictionary shipped in this environment), which cover ~96% of running
Chinese text. Characters outside the table are dropped (the documented
coverage cutoff; extendable by appending to the data blocks).

Readings are the most common Mandarin pronunciation, toneless, ASCII
(ü -> v, the standard keyboard convention — 'v' is in the phone alphabet).
Polyphonic characters get their statistically dominant reading (e.g. 了 le,
长 chang, 行 xing) — the same per-character granularity uroman has.

Format: space-separated tokens, first codepoint is the ideograph, the rest
its reading. Every reading is validated against the closed set of legal
pinyin syllables in tests/test_text.py.
"""

from __future__ import annotations

import functools

# ranks 0-499 (~73% of running text)
_DATA_0 = """
一yi 是shi 人ren 了le 不bu 在zai 有you 大da 中zhong 国guo 和he 为wei 这zhe
上shang 他ta 个ge 地di 年nian 来lai 我wo 会hui 以yi 到dao 时shi 要yao 出chu
的de 生sheng 学xue 说shuo 道dao 民min 家jia 子zi 也ye 成cheng 行xing 下xia
们men 于yu 后hou 就jiu 发fa 自zi 之zhi 对dui 得de 主zhu 长chang 可ke 过guo
天tian 作zuo 分fen 方fang 用yong 多duo 你ni 着zhe 部bu 能neng 市shi 等deng
业ye 全quan 里li 工gong 公gong 经jing 本ben 都dou 而er 高gao 政zheng 法fa
面mian 门men 动dong 日ri 进jin 区qu 事shi 代dai 那na 去qu 心xin 小xiao
同tong 北bei 定ding 开kai 产chan 前qian 其qi 军jun 还hai 然ran 起qi
种zhong 所suo 如ru 现xian 理li 机ji 体ti 表biao 力li 好hao 外wai 与yu
文wen 当dang 两liang 实shi 重zhong 新xin 三san 么me 只zhi 山shan 水shui
关guan 明ming 从cong 化hua 平ping 建jian 又you 制zhi 南nan 内nei 西xi
没mei 此ci 将jiang 员yuan 名ming 手shou 最zui 东dong 头tou 者zhe 月yue
间jian 无wu 安an 看kan 见jian 各ge 城cheng 十shi 相xiang 但dan 已yi
些xie 正zheng 口kou 通tong 想xiang 度du 加jia 第di 她ta 合he 院yuan
物wu 性xing 战zhan 由you 位wei 常chang 点dian 海hai 意yi 场chang 武wu
使shi 次ci 二er 向xiang 治zhi 因yin 立li 数shu 样yang 身shen 情qing
入ru 原yuan 问wen 把ba 路lu 被bei 并bing 利li 石shi 老lao 教jiao 万wan
知zhi 级ji 量liang 任ren 江jiang 及ji 应ying 省sheng 资zi 委wei 务wu
元yuan 美mei 特te 期qi 世shi 湖hu 回hui 系xi 比bi 气qi 汉han 总zong
展zhan 电dian 科ke 金jin 先xian 声sheng 提ti 品pin 设she 或huo 义yi
王wang 社she 很hen 统tong 处chu 四si 首shou 共gong 马ma 形xing 己ji
儿er 司si 太tai 目mu 基ji 领ling 队dui 直zhi 计ji 别bie 女nv 权quan
话hua 少shao 流liu 命ming 至zhi 报bao 米mi 给gei 打da 变bian 果guo
书shu 清qing 活huo 几ji 州zhou 华hua 解jie 议yi 更geng 称cheng 程cheng
今jin 决jue 张zhang 导dao 术shu 府fu 才cai 保bao 交jiao 放fang 管guan
结jie 师shi 便bian 走zou 达da 族zu 反fan 再zai 题ti 色se 五wu 京jing
河he 接jie 条tiao 规gui 式shi 县xian 白bai 它ta 改gai 风feng 光guang
运yun 信xin 受shou 什shen 组zu 听ting 布bu 百bai 济ji 党dang 指zhi
论lun 强qiang 做zuo 取qu 技ji 黄huang 神shen 选xuan 记ji 斯si 真zhen
却que 职zhi 号hao 界jie 件jian 花hua 类lei 何he 眼yan 兵bing 传chuan
带dai 空kong 干gan 农nong 边bian 据ju 集ji 联lian 古gu 广guang 完wan
质zhi 阳yang 难nan 增zeng 历li 史shi 专zhuan 官guan 每mei 住zhu
商shang 即ji 步bu 认ren 车che 台tai 林lin 必bi 死si 游you 举ju
线xian 言yan 皇huang 土tu 团tuan 收shou 考kao 求qiu 德de 叫jiao
近jin 备bei 研yan 争zheng 非fei 具ju 李li 众zhong 连lian 调diao
感gan 转zhuan 笑xiao 革ge 该gai 持chi 始shi 英ying 克ke 士shi 尔er
让rang 拉la 思si 根gen 格ge 造zao 较jiao 际ji 亲qin 单dan 朝chao
红hong 型xing 价jia 校xiao 约yue 器qi 字zi 段duan 周zhou 亚ya 深shen
候hou 则ze 功gong 属shu 积ji 快kuai 图tu 火huo 千qian 准zhun 究jiu
往wang 极ji 育yu 装zhuang 许xu 参can 半ban 令ling 吃chi 观guan 鱼yu
精jing 办ban 像xiang 帝di 八ba 复fu 影ying 告gao 远yuan 群qun 包bao
整zheng 构gou 料liao 随sui 划hua 算suan 象xiang 容rong 示shi 投tou
势shi 热re 值zhi 夫fu 网wang 望wang 源yuan 息xi 语yu 股gu 铁tie
断duan 派pai 速su 怎zen 需xu 片pian 爱ai 律lv 纪ji 支zhi 早zao
况kuang 病bing 境jing 证zheng 编bian
"""

# ranks 500-999 (cumulative ~87%)
_DATA_1 = """
越yue 局ju 推tui 满man 且qie 列lie 觉jue 服fu 双shuang 未wei 居ju
除chu 乐le 企qi 引yin 标biao 确que 织zhi 初chu 青qing 志zhi 率lv
项xiang 飞fei 球qiu 节jie 察cha 龙long 响xiang 药yao 站zhan 施shi
均jun 消xiao 客ke 失shi 轻qing 存cun 低di 甚shen 般ban 击ji 曾ceng
防fang 请qing 离li 落luo 显xian 罗luo 营ying 足zu 素su 视shi 护hu
副fu 食shi 创chuang 余yu 照zhao 兴xing 占zhan 巴ba 虽sui 洲zhou
村cun 费fei 易yi 试shi 星xing 木mu 黑hei 左zuo 宝bao 置zhi 跟gen
央yang 识shi 维wei 采cai 六liu 底di 宫gong 房fang 音yin 环huan 案an
批pi 切qie 斗dou 富fu 乡xiang 另ling 倒dao 若ruo 按an 查cha 故gu
突tu 责ze 严yan 桥qiao 模mo 仅jin 胜sheng 杀sha 围wei 席xi 态tai
破po 承cheng 招zhao 杨yang 负fu 层ceng 须xu 父fu 供gong 续xu
状zhuang 域yu 似si 依yi 银yin 范fan 修xiu 找zhao 九jiu 致zhi 密mi
终zhong 血xue 旅lv 钱qian 赛sai 独du 细xi 效xiao 玉yu 冲chong 获huo
习xi 医yi 演yan 毛mao 尽jin 脸lian 弹dan 楼lou 艺yi 航hang 陆lu
右you 协xie 七qi 攻gong 镇zhen 检jian 写xie 苏su 宗zong 章zhang
注zhu 阿a 抗kang 弟di 坐zuo 验yan 封feng 紧jin 劳lao 户hu 优you
财cai 养yang 适shi 陈chen 喜xi 卫wei 排pai 射she 哥ge 油you 刻ke
留liu 急ji 降jiang 念nian 云yun 微wei 伤shang 例li 景jing 拿na
绝jue 阶jie 座zuo 刘liu 刚gang 害hai 印yin 亿yi 沙sha 母mu 酒jiu
助zhu 闻wen 超chao 审shen 待dai 压ya 升sheng 送song 监jian 策ce
略lve 限xian 竟jing 香xiang 配pei 藏cang 敌di 呢ne 差cha 仍reng
兰lan 温wen 园yuan 树shu 征zheng 善shan 波bo 哪na 词ci 岛dao
止zhi 预yu 怕pa 继ji 皮pi 执zhi 味wei 份fen 角jiao 草cao 男nan
普pu 答da 益yi 谁shui 船chuan 惊jing 核he 街jie 夏xia 宣xuan
掌zhang 田tian 久jiu 著zhu 画hua 辑ji 奇qi 尼ni 剑jian 吧ba 谈tan
背bei 免mian 孩hai 礼li 材cai 愿yuan 洋yang 春chun 架jia 筑zhu
括kuo 晚wan 乱luan 乎hu 讲jiang 尚shang 良liang 友you 临lin 激ji
刀dao 夜ye 室shi 既ji 敢gan 邦bang 挥hui 昌chang 板ban 胡hu 欧ou
福fu 港gang 叶ye 简jian 苦ku 担dan 句ju 岁sui 荆jing 贵gui 娘niang
守shou 辖xia 威wei 宜yi 衣yi 帮bang 块kuai 堂tang 额e 错cuo 剧ju
充chong 欢huan 够gou 孙sun 班ban 呼hu 阵zhen 销xiao 坚jian 练lian
脚jiao 退tui 读du 测ce 吴wu 希xi 宁ning 换huan 版ban 异yi 某mou
顾gu 曲qu 楚chu 典dian 朱zhu 毒du 菜cai 判pan 救jiu 宋song 茶cha
洪hong 含han 顺shun 啊a 鲜xian 败bai 货huo 矿kuang 端duan 兄xiong
归gui 冷leng 忙mang 买mai 险xian 康kang 评ping 肉rou 吗ma 厂chang
永yong 哈ha 沉chen 散san 遗yi 停ting 笔bi 假jia 输shu 牛niu 洞dong
松song 渐jian 顶ding 训xun 录lu 否fou 述shu 毕bi 督du 控kong 丰feng
献xian 姑gu 忽hu 爷ye 互hu 亮liang 纳na 襄xiang 登deng 咱zan
钟zhong 伯bo 臣chen 雄xiong 季ji 脑nao 介jie 鄂e 召zhao 饭fan 暗an
扩kuo 祖zu 齐qi 短duan 烈lie 赶gan 牌pai 恩en 诉su 移yi 诗shi
础chu 露lu 届jie 蒙meng 静jing 喝he 盘pan 卖mai 植zhi 授shou 伊yi
湾wan 博bo 痛tong 减jian 穿chuan 逐zhu 秘mi 庭ting 陵ling 固gu
禁jin 票piao 灵ling 杂za 姓xing 泽ze 吸xi 侧ce 庆qing 妈ma 遇yu
追zhui 甲jia 馆guan 补bu 唐tang 炮pao 沿yan 殿dian 刺ci 怪guai
彩cai 俄e 旧jiu 警jing 索suo 岸an 轮lun 妇fu 载zai 靠kao 附fu
毫hao 怀huai 软ruan 骨gu 探tan 雷lei 旁pang 罪zui 枪qiang 牙ya
迎ying 序xu 慢man 盛sheng 雨yu 墙qiang 恶e 谷gu 顿dun 危wei 稳wen
熟shu
"""

# ranks 1000-1499 (cumulative ~93%)
_DATA_2 = """
概gai 酸suan 操cao 诸zhu 绿lv 佛fo 荣rong 针zhen 托tuo 宽kuan 折zhe
野ye 付fu 午wu 肯ken 库ku 厚hou 缺que 罢ba 耳er 屋wu 嘴zui 末mo
谢xie 巨ju 培pei 页ye 瓦wa 款kuan 犯fan 困kun 店dian 智zhi 拥yong
雪xue 翻fan 圣sheng 戏xi 旗qi 吉ji 婚hun 奖jiang 岩yan 疑yi 币bi
圆yuan 歌ge 廷ting 健jian 卡ka 烧shao 析xi 讨tao 跑pao 烟yan 误wu
仙xian 疗liao 舞wu 亡wang 闭bi 汽qi 伸shen 脱tuo 秋qiu 姐jie 繁fan
侵qin 川chuan 莫mo 麻ma 秀xiu 借jie 寻xun 私si 岗gang 卷juan
跳tiao 丽li 横heng 驻zhu 套tao 兼jian 您nin 君jun 丁ding 束shu
纸zhi 夺duo 袁yuan 灯deng 坏huai 坦tan 丝si 径jing 购gou 阴yin
床chuang 瞧qiao 择ze 墓mu 宪xian 峰feng 遍bian 鲁lu 庙miao 掉diao
丹dan 桃tao 御yu 舰jian 避bi 售shou 怒nu 课ke 播bo 拔ba 奥ao
延yan 虚xu 隐yin 粮liang 络luo 遭zao 摇yao 潜qian 庄zhuang 混hun
厅ting 婆po 奴nu 鼓gu 赵zhao 访fang 睡shui 震zhen 予yu 童tong
徐xu 韦wei 殖zhi 抓zhua 拜bai 吨dun 扬yang 址zhi 洛luo 休xiu
纵zong 逃tao 染ran 纷fen 贸mao 透tou 汇hui 灭mie 蛋dan 森sen 仪yi
塔ta 距ju 狐hu 融rong 郡jun 缓huan 聚ju 盖gai 拍pai 迹ji 忠zhong
释shi 润run 粉fen 涓juan 孔kong 岭ling 搜sou 紫zi 虑lv 促cu 抵di
钢gang 塞sai 寺si 津jin 液ye 码ma 虎hu 坛tan 珍zhen 硬ying
梁liang 奔ben 累lei 役yi 偏pian 迫po 凡fan 损sun 壁bi 哭ku 替ti
税shui 综zong 伦lun 冰bing 盟meng 挂gua 韩han 竞jing 乌wu 尤you
弱ruo 铺pu 妹mei 秦qin 尊zun 竹zhu 珠zhu 迅xun 脉mai 泥ni 鬼gui
纯chun 睛jing 刑xing 途tu 隆long 潮chao 幅fu 杯bei 握wo 谋mou
剂ji 幸xing 奉feng 乘cheng 抱bao 朋peng 谓wei 频pin 崇chong
壮zhuang 骑qi 恐kong 享xiang 鸡ji 虫chong 绍shao 铜tong 呈cheng
泛fan 械xie 摆bai 欲yu 奶nai 敬jing 措cuo 爆bao 暴bao 签qian
猛meng 郭guo 嘉jia 障zhang 缩suo 亦yi 废fei 搞gao 胞bao 埃ai
曰yue 撤che 暖nuan 寒han 订ding 俗su 绩ji 阻zu 盐yan 萨sa 勒le
忘wang 奏zou 孝xiao 贴tie 灰hui 梅mei 触chu 玩wan 默mo 醒xing
胸xiong 莲lian 篇pian 柱zhu 裁cai 啦la 淡dan 抢qiang 捕bu 闹nao
纺fang 截jie 讯xun 朗lang 誉yu 雅ya 忍ren 梦meng 伙huo 勇yong
峡xia 徒tu 丈zhang 尾wei 迷mi 唱chang 泉quan 泰tai 佳jia 残can
闪shan 伍wu 呀ya 疾ji 署shu 剩sheng 贼zei 冠guan 倾qing 豆dou
申shen 贫pin 诺nuo 麦mai 泪lei 羊yang 尖jian 辈bei 镜jing 涉she
贡gong 爹die 缘yuan 摩mo 妻qi 殊shu 贝bei 零ling 映ying 甘gan
骂ma 糖tang 岳yue 饮yin 奋fen 棉mian 雕diao 跃yue 汗han 冒mao
渡du 努nu 赞zan 启qi 阁ge 斤jin 裂lie 患huan 伏fu 池chi 鹿lu
洗xi 劲jin 晋jin 倍bei 圈quan 媒mei 箭jian 沟gou 锋feng 胆dan
凭ping 挑tiao 抬tai 闯chuang 隔ge 弄nong 曹cao 汤tang 苗miao
迁qian 叹tan 唯wei 振zhen 储chu 贯guan 彻che 桌zhuo 祭ji 符fu
僧seng 衡heng 炸zha 旋xuan 喊han 凤feng 黎li 郎lang 援yuan 肥fei
磁ci 忌ji 赏shang 辽liao 祥xiang 董dong 仁ren 辛xin 瑞rui 询xun
敏min 浪lang 貌mao 毁hui 昨zuo 巧qiao 腿tui 抽chou 荷he 陷xian
焦jiao 净jing 腹fu 弃qi 乃nai 湘xiang 亩mu 滑hua 狗gou 冬dong
宏hong 皆jie 番fan 尸shi 伟wei 桂gui 览lan 恢hui 龄ling 绕rao
趣qu 晶jing 坡po 魏wei 摸mo 伴ban 墨mo 浓nong 绪xu 舍she 蓝lan
荡dang 阅yue 井jing 鸿hong 旦dan 惯guan 症zheng 鸟niao 窗chuang
扎zha 辞ci 聘pin 穷qiong 堰yan 宇yu 键jian 荒huang 递di 恨hen
隶li 厉li 杜du 闲xian 腰yao 袭xi 侍shi 灾zai 涨zhang 叔shu 湿shi
寨zhai 幕mu 豪hao 郑zheng 磨mo
"""

# ranks 1500-1999 (cumulative ~96%); mojibake artifacts in the frequency
# corpus (銆 鐨 锛 紝 剉 殑 etc. — double-encoded GBK punctuation) excluded
_DATA_3 = """
浮fu 薄bo 券quan 赤chi 腐fu 译yi 租zu 氧yang 戴dai 邓deng 煤mei
肠chang 牧mu 孤gu 诏zhao 妙miao 旨zhi 堡bao 册ce 锅guo 胖pang
柳liu 阔kuo 吹chui 丘qiu 趋qu 锦jin 颜yan 悬xuan 陶tao 拳quan
诚cheng 尺chi 晓xiao 插cha 蒋jiang 艇ting 勤qin 穴xue 摄she 燕yan
垂chui 罚fa 辆liang 戒jie 稀xi 腾teng 粗cu 袋dai 绘hui 炎yan
氏shi 肩jian 枝zhi 狂kuang 泊bo 估gu 杭hang 扑pu 臂bi 哲zhe
寡gua 偷tou 懂dong 琴qin 悲bei 盾dun 炒chao 稍shao 矛mao 愈yu
籍ji 颁ban 吐tu 呆dai 违wei 亭ting 眉mei 撞zhuang 贷dai 刊kan
巡xun 屈qu 堆dui 曼man 饰shi 碎sui 滚gun 悉xi 寄ji 浜bang 迟chi
描miao 污wu 辅fu 魔mo 烦fan 鼻bi 盗dao 餐can 幼you 凉liang
仗zhang 冈gang 澳ao 驾jia 菌jun 肚du 肃su 爸ba 仰yang 抚fu 慈ci
扶fu 盆pen 仿fang 炼lian 纲gang 倘tang 碗wan 杰jie 忧you 惜xi
扫sao 暂zan 祝zhu 跨kua 渔yu 宾bin 漫man 寿shou 猪zhu 涌yong
凝ning 邻lin 赴fu 恰qia 劝quan 仇chou 践jian 顷qing 赋fu 悄qiao
莱lai 拟ni 贤xian 愤fen 姆mu 乏fa 轰hong 粒li 逼bi 傅fu 陕shan
昆kun 溶rong 葬zang 燃ran 魂hun 挺ting 腊la 耐nai 犹you 辉hui
乳ru 陪pei 颇po 斜xie 棋qi 熊xiong 浅qian 沈shen 姊zi 返fan 翼yi
丧sang 拖tuo 惨can 俊jun 驱qu 袖xiu 惠hui 涂tu 添tian 牵qian
咸xian 详xiang 碰peng 割ge 侯hou 纤xian 柔rou 档dang 糊hu 岂qi
跪gui 拒ju 覆fu 绣xiu 吓xia 宿su 偶ou 揭jie 赖lai 烤kao 卢lu
娃wa 颗ke 邮you 扇shan 伐fa 循xun 衰shuai 弦xian 凯kai 羽yu
枚mei 帅shuai 锁suo 疏shu 搭da 俱ju 帐zhang 胶jiao 赫he 埋mai
蒸zheng 壳ke 彼bi 脏zang 箱xiang 浙zhe 弯wan 瓜gua 挡dang
拱gong 筹chou 疆jiang 肿zhong 膜mo 刷shua 杆gan 凶xiong 债zhai
甜tian 泡pao 玄xuan 贾jia 谱pu 夹jia 乾qian 遣qian 薪xin 灌guan
咬yao 尘chen 填tian 廊lang 钻zuan 丛cong 狼lang 牢lao 脊ji 熙xi
卒zu 碑bei 漠mo 躲duo 削xiao 徽hui 踏ta 贺he 朵duo 遵zun 狠hen
菲fei 撒sa 扰rao 蛇she 锡xi 炉lu 纹wen 匹pi 亏kui 鉴jian 慕mu
跌die 慌huang 穆mu 邀yao 芳fang 爬pa 豫yu 吾wu 奸jian 棒bang
淮huai 捷jie 耕geng 艘sou 齿chi 醉zui 脂zhi 兽shou 滴di 盈ying
卵luan 滋zi 柴chai 溪xi 妃fei 浠xi 碍ai 瓶ping 辩bian 遂sui
怨yuan 拨bo 肌ji 俘fu 挖wa 恒heng 励li 鸣ming 肝gan 腔qiang
偿chang 秒miao 拦lan 允yun 塑su 拆chai 靖jing 耗hao 凌ling 披pi
胁xie 吏li 纽niu 烂lan 尝chang 垸yuan 辟pi 耶ye 艰jian 佩pei
敦dun 疼teng 荐jian 厘li 匠jiang 柏bai 悠you 壤rang 拾shi 乔qiao
轴zhou 妖yao 喷pen 掩yan 璃li 孟meng 轨gui 歇xie 猜cai 晨chen
坊fang 桑sang 堤di 畅chang 瞎xia 氨an 辨bian 鞋xie 昏hun 恭gong
畜chu 浩hao 迪di 雾wu 丢diu 咨zi 擦ca 窝wo 洁jie 飘piao 捉zhuo
搬ban 奈nai 肤fu 愁chou 砖zhuan 辣la 幽you 嘛ma 赢ying 藕ou
挤ji 舒shu 狮shi 耀yao 诊zhen 扣kou 篮lan 尿niao 唤huan 梯ti
勾gou 霍huo 舌she 侠xia 筋jin 枢shu 屏ping 衙ya 殷yin 栏lan
纠jiu 链lian 恋lian 惧ju 笼long 寸cun 冶ye 弥mi 晃huang 叙xu
吊diao 哩li 稿gao 娜na 剥bo 拼pin 欺qi 榜bang 囊nang 汪wang
逆ni 骗pian 堪kan 猎lie 棺guan 胎tai 俩lia 郊jiao 掘jue 匆cong
缝feng 乙yi 藻zao 携xie 慧hui 函han 辱ru 扯che 嫩nen 癌ai 悟wu
滩tan 祸huo 秉bing 慰wei 驰chi 狱yu 砍kan 糕gao 漏lou 吞tun
纬wei 茅mao 渠qu 催cui 踪zong 叛pan 浑hun 牲sheng 杖zhang
鞭bian 腺xian 邪xie 欣xin 汝ru 碳tan 彭peng 咐fu 椒jiao
绳sheng 颈jing 漆qi 遥yao 夷yi 郁yu 斑ban 忆yi 阀fa 卑bei
"""


# common traditional -> simplified variant pairs (also covers most Japanese
# shinjitai-divergent kanji), so zh-TW / Japanese-kanji text reads through
# the simplified table. Format: traditional char immediately followed by its
# simplified equivalent.
_TRAD_PAIRS = """
國国 學学 會会 來来 個个 們们 時时 說说 為为 這这 裡里 裏里 後后 麼么
對对 發发 當当 無无 動动 開开 現现 關关 點点 經经 樣样 長长 門门 問问
間间 還还 從从 業业 頭头 實实 體体 東东 車车 話话 過过 進进 號号 員员
機机 電电 與与 內内 幾几 產产 處处 見见 萬万 邊边 氣气 兩两 讓让 馬马
認认 書书 應应 場场 報报 聽听 錢钱 種种 飛飞 師师 語语 漢汉 雖虽 變变
戰战 計计 記记 論论 講讲 達达 億亿 選选 歡欢 離离 連连 遠远 運运 導导
觀观 歲岁 濟济 勞劳 樂乐 綠绿 紅红 級级 紙纸 結结 統统 絕绝 給给 絲丝
網网 總总 線线 組组 繼继 續续 維维 難难 雙双 雞鸡 島岛 農农 辦办 務务
勢势 勝胜 區区 醫医 華华 協协 單单 賣卖 買买 貝贝 負负 貨货 質质 費费
資资 賽赛 贏赢 輕轻 輪轮 轉转 較较 載载 遲迟 適适 遺遗 鄉乡 釋释 銀银
銅铜 鐵铁 錯错 鍵键 鎮镇 閉闭 閱阅 陽阳 陰阴 際际 隨随 隱隐 雲云 須须
頁页 頂顶 順顺 領领 頻频 題题 顏颜 願愿 風风 飯饭 飲饮 養养 館馆 驚惊
驗验 鬥斗 魚鱼 鳥鸟 鳴鸣 麗丽 麥麦 黨党 齊齐 齒齿 龍龙 優优 兒儿 價价
儀仪 傳传 傷伤 備备 倫伦 偉伟 側侧 傑杰 創创 劇剧 劃划 勁劲 勵励 勸劝
參参 叢丛 嚴严 啟启 喚唤 嘗尝 嚇吓 團团 園园 圓圆 圖图 壓压 壞坏 壯壮
聲声 殼壳 複复 夢梦 奪夺 奮奋 婦妇 媽妈 孫孙 寧宁 寶宝 審审 寫写 寬宽
將将 專专 尋寻 屆届 層层 屬属 歸归 錄录 徵征 慶庆 憶忆 懷怀 戀恋 戲戏
擁拥 擊击 擔担 據据 揮挥 損损 擴扩 攝摄 敗败 敵敌 數数 斷断 舊旧 曆历
極极 構构 槍枪 樓楼 標标 樹树 橋桥 檢检 歐欧 殘残 殺杀 氫氢 滅灭 滿满
濃浓 灣湾 燈灯 爭争 爲为 爺爷 牆墙 獨独 獲获 環环 礎础 禮礼 稅税 積积
窮穷 竊窃 競竞 筆笔 節节 簡简 糧粮 緊紧 罰罚 義义 習习 聯联 脈脉 腦脑
臉脸 興兴 舉举 藝艺 藥药 蘇苏 蘭兰 蟲虫 衛卫 製制 規规 視视 覺觉 訓训
設设 許许 訴诉 診诊 詞词 試试 詩诗 誠诚 誤误 談谈 請请 諸诸 證证 識识
譯译 議议 護护 讀读 豐丰 賓宾 賢贤 賦赋 購购 貴贵 贊赞 趨趋 躍跃 輝辉
辭辞 遞递 鄧邓 鄰邻 針针 鋼钢 錦锦 鎖锁 鏡镜 陸陆 隊队 階阶 隻只 雜杂
預预 頓顿 顯显 飾饰 駐驻 騎骑 驅驱 髮发 鬆松 麵面 鳳凤 鴻鸿 亞亚 溫温
聞闻 韋韦 剛刚 崗岗 廠厂 廣广 彈弹 彎弯 徹彻 態态 惡恶 愛爱 憲宪 檔档
歷历 測测 濱滨 灘滩 爐炉 牽牵 猶犹 獎奖 監监 盡尽 確确 碼码 礦矿 禍祸
稱称 穩稳 築筑 籃篮 納纳 紀纪 約约 終终 細细 織织 繞绕 罷罢 聖圣 肅肃
膽胆 臨临 薦荐 虛虚 衝冲 補补 裝装 覽览 訂订 訪访 評评 調调 謀谋 謝谢
譜谱 貫贯 販贩 責责 賞赏 輯辑 輸输 辯辩 遷迁 郵邮 鄭郑 鈴铃 銷销 鍋锅
鏈链 閃闪 閣阁 陣阵 險险 靜静 韓韩 頗颇 類类 顧顾 飽饱 馮冯 駕驾 騙骗
"""


# below-rank-2000 simplified chars referenced by _TRAD_PAIRS
_DATA_EXTRA = """
氢qing 窃qie 滨bin 贩fan 铃ling 饱bao 冯feng
"""


@functools.lru_cache(maxsize=1)
def _table() -> dict[str, str]:
    table = {}
    for block in (_DATA_0, _DATA_1, _DATA_2, _DATA_3, _DATA_EXTRA):
        for tok in block.split():
            table[tok[0]] = tok[1:]
    for tok in _TRAD_PAIRS.split():
        if len(tok) == 2 and tok[1] in table and tok[0] not in table:
            table[tok[0]] = table[tok[1]]
    return table


def pinyin(ch: str) -> str | None:
    """Toneless-pinyin reading of one Han ideograph, or None if outside the
    bundled frequency table."""
    return _table().get(ch)


def coverage() -> int:
    """Number of ideographs in the bundled table."""
    return len(_table())

